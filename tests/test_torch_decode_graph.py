"""A decode step replayed as a CUDA graph (``models/decode_graph.py``).

On the CPU:
* ``decode_graph_refusal``: which steps run eagerly, and why (CPU tensors,
  a DTensor cache, an int8 cache, a windowed layer, a wanted gradient, an
  active account, a held MoE over more tokens than its slots take), and that the rule finds nothing against the reduced
  families' steps but the card;
* ``LM.decode`` through the device-position path (the position one int64
  tensor, as a replayed graph reads it; K3's route taken, the valid length
  read from that tensor) equal bit for bit to the int path, logits and
  cache, for the reduced internlm2, mamba2 and granite at two positions;
* the position check, the release of a graph with its cache, and the
  ``decode.graph_replay_pct`` reader.

On the card (``-m cuda``): graph and eager decode serve the same tokens over
15 steps for each family, reduced; the counts read one capture and 14
replays; ``torch.cuda.memory_allocated()`` returns to its value from before
the batch once its cache is freed; a held MoE's batch over the slots' tokens
runs eagerly; a capture under the profiler notes its spans' device counts
after the step; a capture with less than ``CAPTURE_HEADROOM`` free empties
the allocator's cache first; K3 with a device length at lengths
that leave trailing splits empty matches its plain version.
"""
import gc
import importlib.util
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.analysis.account import Account  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import scope  # noqa: E402
from repro_torch.core.scope import Span  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import decode_graph as dg  # noqa: E402
from repro_torch.models.moe import SLOT_TOKENS  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
B, S, GEN = 2, 12, 16
FAMILIES = ["internlm2-1.8b", "mamba2-1.3b", "granite-4.0-h-small"]


def _batch(arch, device="cpu", kv_dtype="bfloat16", seed=0, batch=B):
    """A reduced model, a prefilled cache of ``batch`` rows grown to S + GEN
    positions and the first token."""
    lm = LM(get_config(arch).reduced(), device=device, seed=seed)
    prompts = torch.randint(0, lm.cfg.vocab_size, (batch, S), device=device,
                            generator=torch.Generator(device=device).manual_seed(seed + 1))
    with torch.inference_mode():
        out = lm.forward(prompts, mode="prefill", kv_dtype=kv_dtype)
        cache = serve.grow_cache(lm.cfg, out["cache"], S + GEN)
        tok = torch.argmax(out["logits"][:, -1], -1)[:, None]
    return lm, cache, tok


def _clone(cache):
    if isinstance(cache, dict):
        return {k: _clone(v) for k, v in cache.items()}
    return cache.clone()


# ------------------------------------------------------------------ the rule
def _refusal(case):
    arch = {"windowed": "gemma3-4b", "moe_sorted": "granite-4.0-h-small"}.get(
        case, "internlm2-1.8b")
    lm, cache, tok = _batch(arch, kv_dtype="int8" if case == "int8" else "bfloat16")
    if case == "moe_sorted":        # the rule reads the token's rows alone
        tok = torch.zeros(SLOT_TOKENS + 1, 1, dtype=torch.long)
    if case == "gradient":
        lm.requires_grad_(True)
        return dg.decode_graph_refusal(lm, cache, tok)
    with torch.inference_mode():
        if case == "account":
            with Account():
                return dg.decode_graph_refusal(lm, cache, tok)
        return dg.decode_graph_refusal(lm, cache, tok)


RULE = [("cpu", "not on a CUDA card"), ("int8", "a quantized cache"),
        ("windowed", "a windowed layer"), ("gradient", "a gradient"),
        ("account", "a dispatch mode"), ("moe_sorted", "a host read in the MoE dispatch")]


@pytest.mark.parametrize("case,reason", RULE, ids=[c for c, _ in RULE])
def test_the_rule_refuses(case, reason):
    assert _refusal(case) == reason


DTENSOR = r"""
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.configs import get_config
from repro_torch.launch.mesh import fake_process_group
from repro_torch.models import decode_graph as dg
from repro_torch.models.lm import LM

lm = LM(get_config("internlm2-1.8b").reduced(), device="cpu", seed=0)
cache = lm.init_cache(2, 16)
with fake_process_group(2):
    mesh = init_device_mesh("cpu", (2,))
    cache = {k: DTensor.from_local(t, mesh, [Replicate()]) for k, t in cache.items()}
    print(dg.decode_graph_refusal(lm, cache, torch.zeros(2, 1, dtype=torch.long)))
"""


def test_the_rule_refuses_a_dtensor_cache():
    res = subprocess.run([sys.executable, "-c", DTENSOR], env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split("\n")[-2] == "a DTensor or another tensor subclass"


@pytest.mark.parametrize("arch", FAMILIES + ["whisper-medium", "jamba-1.5-large-398b"])
def test_the_rule_finds_nothing_but_the_card(arch, monkeypatch):
    """Every layer of these reduced steps is one K3 takes (bf16, hd 16, no
    window), so on CUDA tensors the step would run as a graph."""
    lm, cache, tok = _batch(arch) if arch in FAMILIES else (None, None, None)
    if lm is None:
        lm = LM(get_config(arch).reduced(), device="cpu", seed=0)
        cache = lm.init_cache(B, S + GEN)
        tok = torch.zeros(B, 1, dtype=torch.long)
    with torch.inference_mode():
        assert dg.decode_graph_refusal(lm, cache, tok) == "not on a CUDA card"
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
        assert dg.decode_graph_refusal(lm, cache, tok) is None


# ----------------------------------------------- the device-position path
@pytest.mark.parametrize("steps", [1, 3], ids=["pos_S", "pos_S+2"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_the_device_position_path_is_the_int_path(arch, steps, monkeypatch):
    """The same tokens fed to ``steps`` decode steps: once with the position
    an int (K3's key range from it), once through ``LM.decode``'s graph
    program run eagerly (the position one int64 tensor, K3's valid length
    read from it over the whole cache's grid).  Logits and caches agree bit
    for bit."""
    monkeypatch.setattr(ta, "_on_card", lambda *t: True)       # K3's route, its plain version
    lm, cache, tok = _batch(arch)
    other = _clone(cache)
    toks = torch.randint(0, lm.cfg.vocab_size, (steps, B, 1),
                         generator=torch.Generator().manual_seed(3))
    toks[0] = tok
    with torch.inference_mode():
        want = [lm.decode(cache, toks[i], S + i)[0] for i in range(steps)]
        monkeypatch.setattr(dg, "decode_graph_refusal", lambda *a: None)
        got = []
        for i in range(steps):
            lm._decode_graphs = dg.DecodeGraphs()     # each call the model's first: eager
            before = dict(dg.COUNTS)
            got.append(lm.decode(other, toks[i], S + i)[0])
            assert dg.COUNTS["eager"] == before["eager"] + 1
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    for a, b in zip(dg.cache_leaves(cache), dg.cache_leaves(other)):
        assert torch.equal(a, b)


def test_the_host_checks_the_position():
    lm, cache, tok = _batch("internlm2-1.8b")
    with pytest.raises(ValueError, match="outside the cache's 28 positions"):
        dg._check_pos(lm, cache, S + GEN)
    assert dg._check_pos(lm, cache, S) == S


def test_a_graph_goes_with_its_cache():
    """An entry kept for a cache is dropped when one of its tensors is freed."""
    graphs = dg.DecodeGraphs()
    cache = {"k": torch.zeros(2, 3), "v": torch.zeros(2, 3)}
    tok = torch.zeros(2, 1, dtype=torch.long)
    key = dg._key(cache, tok)
    graphs._keep(key, SimpleNamespace(), cache)
    assert len(graphs) == 1
    del cache
    gc.collect()
    assert len(graphs) == 0


# --------------------------------------------------------------- the reader
def _reader():
    path = ROOT / "cardbench" / "metrics" / "decode.graph_replay_pct.py"
    spec = importlib.util.spec_from_file_location("graph_replay_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("graphs,want", [
    (["capture"] + ["replay"] * 7, 87.5),
    (["eager", "capture", "replay", "replay"], 50.0),
    ([None] * 3, None),           # a program that notes no graph (the parent's)
    ([], None),
])
def test_the_replay_share_reader(graphs, want, monkeypatch):
    spans = [Span("decode", i + 1, 0, 0, 1, {} if g is None else {"graph": g})
             for i, g in enumerate(graphs)]
    spans.append(Span("layer", 99, 1, 0, 1, {"graph": "eager"}))
    monkeypatch.setattr(scope, "spans", lambda: spans)
    assert _reader()(SimpleNamespace(trace=None)) == want


# ----------------------------------------------------------------- the card
def _serve(lm, cache, tok, steps=GEN - 1):
    toks = []
    with torch.inference_mode():
        for i in range(steps):
            logits, cache = lm.decode(cache, tok, S + i)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            toks.append(tok)
    return torch.cat(toks, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_graph_and_eager_serve_the_same_tokens(arch, monkeypatch):
    """15 steps of a reduced batch on the card, replayed from one capture,
    against the same steps run eagerly: the same tokens; one capture and 14
    replays; once the batch's cache is freed, the allocated bytes are what
    they were before the batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph captures CUDA work")
    lm, cache, tok = _batch(arch, device="cuda")
    _serve(lm, _clone(cache), tok, steps=2)         # the model's first step, one capture
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    before = dict(dg.COUNTS)
    graph = _serve(lm, _clone(cache), tok).cpu()
    torch.cuda.synchronize()
    got = {k: dg.COUNTS[k] - before[k] for k in before}
    gc.collect()
    assert len(lm._decode_graphs) == 0
    assert torch.cuda.memory_allocated() == base
    assert got == {"capture": 1, "replay": GEN - 2, "eager": 0}
    monkeypatch.setattr(dg, "decode_graph_refusal", lambda *a: "eager on purpose")
    eager = _serve(lm, cache, tok).cpu()
    assert torch.equal(graph, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("free,emptied", [(0, 1), (dg.CAPTURE_HEADROOM, 0)])
def test_a_capture_short_of_memory_empties_the_cache_first(free, emptied, monkeypatch):
    """A capture that finds less than ``CAPTURE_HEADROOM`` free on the device
    (here reported so) hands the allocator's cached blocks back before it
    starts, once; one with that much free does not; both serve the tokens of
    the eager steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph captures CUDA work")
    lm, cache, tok = _batch("mamba2-1.3b", device="cuda")
    _serve(lm, _clone(cache), tok, steps=1)         # the model's first step
    calls, empty = [], torch.cuda.empty_cache
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (free, 80 << 30))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: (calls.append(1), empty())[1])
    graph = _serve(lm, _clone(cache), tok).cpu()
    monkeypatch.undo()
    assert len(calls) == emptied
    monkeypatch.setattr(dg, "decode_graph_refusal", lambda *a: "eager on purpose")
    assert torch.equal(graph, _serve(lm, cache, tok).cpu())


@pytest.mark.cuda
def test_a_held_moe_batch_over_the_slots_runs_eagerly():
    """Reduced granite at more rows than ``SLOT_TOKENS``: the held MoE takes
    its sorted layout, which the host reads, so no step is captured: all
    three run eagerly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph captures CUDA work")
    lm, cache, tok = _batch("granite-4.0-h-small", device="cuda", batch=SLOT_TOKENS + 16)
    with torch.inference_mode():
        assert dg.decode_graph_refusal(lm, cache, tok) == "a host read in the MoE dispatch"
    before = dict(dg.COUNTS)
    _serve(lm, cache, tok, steps=3)
    assert {k: dg.COUNTS[k] - before[k] for k in before} == {"capture": 0, "replay": 0,
                                                             "eager": 3}
    assert len(lm._decode_graphs) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-4.0-h-small"])
def test_a_capture_under_the_profiler(arch):
    """The profiler on: the first step with a new cache captures (its spans
    recorded, with K3's bytes and the MoE's pairs read after the step), the
    next replays and records no span inside."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph captures CUDA work")
    lm, cache, tok = _batch(arch, device="cuda")
    _serve(lm, _clone(cache), tok, steps=1)         # the model's first step
    scope.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _serve(lm, cache, tok, steps=2)
        torch.cuda.synchronize()
    spans = scope.spans()
    scope.clear()
    steps = [s for s in spans if s.tag == "decode"]
    assert [s.attrs["graph"] for s in steps] == ["capture", "replay"]
    assert not [s for s in spans if s.parent == steps[1].id]        # a replay runs no Python
    inside = scope.subtree(spans, "decode")
    K = lm.cfg.num_kv_heads
    for s in (s for s in inside if s.tag == "k3"):
        assert s.attrs["bytes"] == 2 * B * (S + 1) * K * lm.cfg.head_dim * 2
    for s in (s for s in inside if s.tag == "moe"):
        assert s.attrs["dropped"] == 0 and 0 <= s.attrs["pairs"] <= B * lm.cfg.moe.top_k


@pytest.mark.cuda
@pytest.mark.parametrize("S_,valid,splits", [(300, 120, 7), (64, 50, 3), (40, 29, 1),
                                             (32_784, 24_577, 8)])
def test_k3_with_a_device_length(S_, valid, splits):
    """K3 over all S keys' grid with the valid length on the device, the
    trailing splits empty, against its plain version at the same grid and
    the int range's kernel call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 is CUDA C++ with no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(S_)
    q, k, v = (torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
               for s in ((4, 1, 16, 128), (4, S_, 8, 128), (4, S_, 8, 128)))
    k[:, valid:], v[:, valid:] = 999.0, -999.0
    n = torch.tensor([valid], device="cuda")
    got = da._launch(q, k, v, lo=0, hi=S_, splits=splits, valid=n)
    plain = da.decode_attention_plain(q, k, v, lo=0, hi=S_, splits=splits, valid=n)
    ranged = da.decode_attention(q, k, v, lo=0, hi=valid)
    for want in (plain, ranged):
        err = (got.float() - want.float()).norm(dim=-1)
        assert torch.all(err <= 3e-2 * want.float().norm(dim=-1))
