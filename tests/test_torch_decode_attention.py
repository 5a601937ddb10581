"""K3, the decode-attention kernel, on the CPU: its plain version and the
rule that sends a call to it.

* The plain version (``kernels/decode_attention.py``: the keys split, each
  split's max, sum and P V, then the splits combined) against the port's
  dot path and the JAX package's, at G in {1, 2, 8}, hd in {16, 64, 128}, a
  valid length below S, an int window, one split and many, a ragged last
  split, and a valid length held in a tensor (a decode step replayed as a
  CUDA graph) with the splits cut over all S keys, the trailing ones empty;
  in f32 at test_attention.py's 1e-5, in bf16 at K1's 3e-2.  Keys outside
  the range are set to values that would show if they were read.
* ``k3_splits``: enough blocks, no split shorter than its floor, none empty.
* ``k3_refusal``: which inputs go to K3 and which stay on the dot path (the
  card test holds the kernel itself).
* The route: with the card check answered yes, a decode call goes through
  the "k3" span to the plain version; a served decode step gives the dot
  path's logits; the shard-wise DTensor path stays on the dot path.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro.models import attention as ja  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import scope  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models.lm import LM, _quantize_kv  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# (name, S, valid length, window, splits): keys lo .. valid-1 with
# lo = valid - window under a window
CASES = [
    ("one_split", 40, 29, None, 1),
    ("window", 40, 37, 9, 2),
    ("many_splits", 300, 290, None, 7),
    ("ragged_last", 64, 61, 20, 3),
]
# the valid length in a tensor: the splits cut over all S keys (a cache's
# capacity), those past the length empty
DEVICE_CASES = [
    ("device_length_trailing_empty", 300, 120, None, 7),    # splits of 43: 3 hold keys
    ("device_length_cut_split", 64, 50, None, 3),           # of 22: the third cut to 6
    ("device_length_one_split", 40, 29, None, 1),
]


def _inputs(B, S, H, K, hd, lo, hi, dtype, seed):
    """q [B,1,H,hd], k/v [B,S,K,hd], drawn in numpy; the keys outside lo .. hi-1
    set to 999 and their values to -999."""
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal(s).astype(np.float32)
               for s in ((B, 1, H, hd), (B, S, K, hd), (B, S, K, hd)))
    for a in (k, v):
        sign = 1.0 if a is k else -1.0
        a[:, :lo] = sign * 999.0
        a[:, hi:] = sign * 999.0
    return q, k, v


def _kw(valid, window):
    return dict(causal=False, window=window, q_offset=valid - 1, kv_valid_len=valid)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("name,S,valid,window,splits", CASES + DEVICE_CASES,
                         ids=[c[0] for c in CASES + DEVICE_CASES])
def test_plain_matches_the_dot_path(name, S, valid, window, splits, G, hd, dtype):
    K = 2
    lo = max(0, valid - window) if window else 0
    arrays = _inputs(2, S, G * K, K, hd, lo, valid, np.float32, seed=G * hd + S)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    if name.startswith("device_length"):
        got = da.decode_attention_plain(q, k, v, lo=0, hi=S, splits=splits,
                                        valid=torch.tensor([valid]))
    else:
        got = da.decode_attention_plain(q, k, v, lo=lo, hi=valid, splits=splits)
    want = ta._attention_dot(q, k, v, **_kw(valid, window))
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert got.float().abs().max() < 10          # no key outside the range was read


@functools.lru_cache(maxsize=None)
def _jax_dot(window, q_offset, kv_valid_len):
    return jax.jit(functools.partial(ja.attention_dot, causal=False, window=window,
                                     q_offset=q_offset, kv_valid_len=kv_valid_len))


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("name,S,valid,window,splits", CASES + DEVICE_CASES,
                         ids=[c[0] for c in CASES + DEVICE_CASES])
def test_plain_matches_jax(name, S, valid, window, splits, G, hd):
    K = 2
    lo = max(0, valid - window) if window else 0
    q, k, v = _inputs(1, S, G * K, K, hd, lo, valid, np.float32, seed=7 + G + hd)
    if name.startswith("device_length"):
        rng = dict(lo=0, hi=S, valid=torch.tensor([valid]))
    else:
        rng = dict(lo=lo, hi=valid)
    got = da.decode_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                    splits=splits, **rng)
    want = _jax_dot(window, valid - 1, valid)(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_plain_takes_the_default_splits_and_any_scale():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 700, 4, 2, 64, 0, 700, np.float32, 3))
    got = da.decode_attention_plain(q, k, v, lo=0, hi=700, softmax_scale=0.3)
    want = ta._attention_dot(q, k, v, causal=False, softmax_scale=0.3)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("blocks,n", [(32, 24_577), (32, 16_385), (512, 1_088), (512, 257),
                                      (8, 100), (64, 5_000), (1, 1), (264, 10_000)])
@pytest.mark.parametrize("per_sm", [1, 2])
def test_split_rule(blocks, n, per_sm):
    splits, chunk = da.k3_splits(blocks, n, blocks_per_sm=per_sm)
    assert 1 <= splits and (splits - 1) * chunk < n <= splits * chunk     # none empty
    assert chunk >= min(n, da.MIN_SPLIT_KEYS)
    slots = per_sm * da.SMS_H100
    assert splits * blocks <= max(slots, blocks)                         # one round
    if n >= da.MIN_SPLIT_KEYS * slots // blocks:
        assert (splits + 1) * blocks > slots                             # and it is full


def test_split_rule_at_the_cells():
    """internlm2-1.8b.longdoc at its median step: 4 rows x 8 kv heads over
    24,577 keys, 2 heads a block: 8 splits fill 2 blocks on each of 132 SMs;
    internlm2-1.8b.short: 64 x 8 blocks over at most 1,088 keys already fill
    them, so one split and no combine launch."""
    assert da._split(4, 16, 8, 24_577) == (2, 8, 3_073)
    assert da._split(64, 16, 8, 1_088) == (2, 1, 1_088)
    assert da._split(4, 64, 8, 24_577) == (8, 4, 6_145)       # G 8: one block an SM


def _base(**over):
    B, S, H, K, hd = 2, 40, 4, 2, 64
    kw = dict(impl="dot", causal=False, window=None, q_offset=S - 1, kv_valid_len=S)
    q = torch.zeros(B, 1, H, hd, dtype=torch.bfloat16)
    k = torch.zeros(B, S, K, hd, dtype=torch.bfloat16)
    v = torch.zeros_like(k)
    tensors = dict(q=q, k=k, v=v)
    for name, val in over.items():
        (tensors if name in tensors else kw)[name] = val
    return tensors, kw


def _int8_cache():
    kq, ks = _quantize_kv(torch.zeros(2, 40, 2, 64))
    return dict(k=kq, v=kq, k_scale=ks, v_scale=ks)


RULE = [   # (case, changed inputs, the reason; None-like "not on a CUDA card" = K3 takes it)
    ("bf16", {}, "not on a CUDA card"),
    ("f16", dict(q=torch.zeros(2, 1, 4, 64, dtype=torch.float16),
                 k=torch.zeros(2, 40, 2, 64, dtype=torch.float16),
                 v=torch.zeros(2, 40, 2, 64, dtype=torch.float16)), "not on a CUDA card"),
    ("int_window", dict(window=8), "not on a CUDA card"),
    ("global_window", dict(window=-1), "not on a CUDA card"),
    ("hd16", dict(q=torch.zeros(2, 1, 4, 16, dtype=torch.bfloat16),
                  k=torch.zeros(2, 40, 2, 16, dtype=torch.bfloat16),
                  v=torch.zeros(2, 40, 2, 16, dtype=torch.bfloat16)), "not on a CUDA card"),
    ("int8_scales", None, "a quantized cache"),
    ("tensor_window", dict(window=torch.tensor(8)), "a tensor window"),
    ("prefill", dict(q=torch.zeros(2, 3, 4, 64, dtype=torch.bfloat16)),
     "more than one query row"),
    ("hd96", dict(q=torch.zeros(2, 1, 4, 96, dtype=torch.bfloat16),
                  k=torch.zeros(2, 40, 2, 96, dtype=torch.bfloat16),
                  v=torch.zeros(2, 40, 2, 96, dtype=torch.bfloat16)), "head_dim"),
    ("f32", dict(q=torch.zeros(2, 1, 4, 64), k=torch.zeros(2, 40, 2, 64),
                 v=torch.zeros(2, 40, 2, 64)), "dtype"),
    ("mixed_dtype", dict(q=torch.zeros(2, 1, 4, 64)), "dtype"),
    ("chunked", dict(impl="chunked"), "impl"),
    ("tensor_position", dict(kv_valid_len=torch.tensor(5), window=8), "a tensor position"),
    ("device_length", dict(kv_valid_len=torch.tensor([5])), "not on a CUDA card"),
    ("device_length_causal", dict(kv_valid_len=torch.tensor([5]), causal=True),
     "a tensor position"),
    ("device_length_int32", dict(kv_valid_len=torch.tensor([5], dtype=torch.int32)),
     "a tensor position"),
    ("no_key", dict(kv_valid_len=0), "no key"),
    ("gradient", dict(q=torch.zeros(2, 1, 4, 64, dtype=torch.bfloat16, requires_grad=True)),
     "a gradient"),
]


@pytest.mark.parametrize("case,over,reason", RULE, ids=[c[0] for c in RULE])
def test_dispatch_rule(case, over, reason):
    tensors, kw = _base(**(over or {}))
    if case == "int8_scales":
        cache = _int8_cache()
        tensors.update(k=cache["k"], v=cache["v"])
        kw.update(k_scale=cache["k_scale"], v_scale=cache["v_scale"])
    assert ta.k3_refusal(tensors["q"], tensors["k"], tensors["v"], **kw) == reason


def test_key_range_folds_valid_length_causal_limit_and_window():
    k = torch.zeros(1, 50, 1, 16)
    rng = functools.partial(ta._key_range, k)
    assert rng(causal=False, window=None, q_offset=29, kv_valid_len=30) == (0, 30)
    assert rng(causal=False, window=8, q_offset=29, kv_valid_len=30) == (22, 30)
    assert rng(causal=True, window=None, q_offset=9, kv_valid_len=None) == (0, 10)
    assert rng(causal=False, window=0, q_offset=0, kv_valid_len=None) == (0, 50)
    assert rng(causal=False, window=100, q_offset=29, kv_valid_len=80) == (0, 50)


@pytest.fixture
def on_card(monkeypatch):
    """Answer the rule's card check yes, so that K3's route runs on the CPU
    (where ``decode_attention`` takes its plain version)."""
    monkeypatch.setattr(ta, "_on_card", lambda *t: True)
    scope.clear()
    yield
    scope.clear()


@pytest.mark.parametrize("window", [None, 9])
def test_route_runs_the_plain_version_inside_the_k3_span(on_card, window):
    valid = 37
    lo = valid - window if window else 0
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(2, 40, 4, 2, 64, lo, valid, np.float32, 5))
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]):
        got = ta.attention(q, k, v, impl="dot", **_kw(valid, window))
    assert torch.equal(got, da.decode_attention_plain(q, k, v, lo=lo, hi=valid))
    spans = {s.tag: s for s in scope.spans()}
    assert spans["attention_core"].attrs == {"cast_bytes": 0}
    assert spans["k3"].parent == spans["attention_core"].id
    assert spans["k3"].attrs == {"bytes": 2 * 2 * (valid - lo) * 2 * 64 * 2}
    assert spans["k3"].attrs["bytes"] == da.kv_bytes(k, lo, valid)


def test_served_decode_through_the_route_matches_the_dot_path(monkeypatch):
    """The reduced internlm2 (bf16, hd 16, 4 layers), the same tokens fed to
    4 decode steps: through K3's route the first step's logits lie within
    K1's bf16 tolerance (3e-2 of the largest logit) of the dot path's.  Later
    steps read keys that earlier steps' rounding moved, and the gap grows
    as it does for the reference's other online softmax, the chunked path
    (which rounds the unnormalised probabilities as K3 does): K3's gap stays
    within 1.5 times the chunked path's at every step."""
    lm = LM(get_config("internlm2-1.8b").reduced(), device="cpu", seed=0)
    assert lm.cfg.head_dim in da.HEAD_DIMS and lm.cfg.dtype == "bfloat16"
    prompts = torch.randint(0, lm.cfg.vocab_size, (2, 12),
                            generator=torch.Generator().manual_seed(1))
    toks = torch.randint(0, lm.cfg.vocab_size, (4, 2, 1),
                         generator=torch.Generator().manual_seed(2))

    def chunked(q, k, v, **kw):
        return ta._attention_chunked(q, k, v, chunk=4, **kw)

    runs = {}
    for path in ("dot", "k3", "chunked"):
        monkeypatch.setattr(ta, "_on_card", lambda *t, on=path != "dot": on)
        if path == "chunked":
            monkeypatch.setattr(ta, "attention_decode", chunked)
        with torch.inference_mode():
            out = lm.forward(prompts, mode="prefill")
            cache = serve.grow_cache(lm.cfg, out["cache"], 16)
            runs[path] = torch.stack([lm.decode(cache, toks[i], 12 + i)[0].float()
                                      for i in range(4)])
    scale = runs["dot"].abs().max()
    gap = {p: ((runs[p] - runs["dot"]).abs() / scale).amax(dim=(1, 2, 3)) for p in runs}
    assert gap["k3"][0] <= 3e-2
    assert torch.all(gap["k3"] <= 1.5 * gap["chunked"]), (gap["k3"], gap["chunked"])


DTENSOR = r"""
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.launch.mesh import fake_process_group
from repro_torch.models import attention as ta

def refuse(*a, **k):
    raise AssertionError("the shard-wise path took K3")

ta._on_card = lambda *t: True
ta.attention_decode = refuse
with fake_process_group(2):
    mesh = init_device_mesh("cpu", (2,))
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g).to(torch.bfloat16)
               for s in ((2, 1, 4, 64), (2, 40, 2, 64), (2, 40, 2, 64)))
    qd, kd, vd = (DTensor.from_local(t, mesh, [Replicate()]) for t in (q, k, v))
    print(ta.k3_refusal(qd, kd, vd, impl="dot", causal=False, q_offset=39, kv_valid_len=40))
    out = ta.attention(qd, kd, vd, impl="dot", causal=False, q_offset=39, kv_valid_len=40)
    want = ta._attention_dot(q, k, v, causal=False, q_offset=39, kv_valid_len=40)
    print(torch.equal(out.to_local(), want))
"""


def test_dtensor_stays_on_the_dot_path():
    res = subprocess.run([sys.executable, "-c", DTENSOR], env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split("\n")[-3:-1] == ["a DTensor or another tensor subclass", "True"]


def test_wrapper_refuses_what_k3_does_not_take():
    q = torch.zeros(1, 1, 2, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="key range"):
        da.decode_attention(q, k, k, lo=3, hi=3)
    with pytest.raises(ValueError, match="key range"):
        da.decode_attention(q, k, k, lo=0, hi=9)
    with pytest.raises(ValueError, match="q \\[B,1,H,hd\\]"):
        da.decode_attention(torch.zeros(1, 2, 2, 64), k, k, lo=0, hi=8)
    with pytest.raises(ValueError, match="no K3 kernel"):
        da._launch(q, k, k, lo=0, hi=8)
    with pytest.raises(RuntimeError, match="no backward"):
        da.decode_attention(q.float().requires_grad_(), k.float(), k.float(), lo=0, hi=8)
