"""Port parity: the Mamba-2 block, repro_torch.models.ssm, against JAX.

Inputs are drawn once with numpy from a seed and fed to both frameworks,
in float32, at the tolerance of tests/test_ssm.py (atol = rtol 1e-4):

* ``ssd_chunked`` against JAX ``ssd_chunked`` and ``ssd_ref`` on the cases
  of tests/test_ssm.py:24-34, the state carried over a split sequence
  (:37-50) and chained decode steps (:53-61);
* ``causal_conv`` and ``causal_conv_step``;
* ``mamba_block`` prefill and decode on the same parameters.

And K4's side of the block on the CPU: its plain version is the eager code
it replaced, bit for bit; the rule that routes a prefill to it
(``k4_refusal``) gives each reason; the ``conv`` span notes the route and a
``k4`` span the call's shape; ``work`` counts its bytes.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import scope  # noqa: E402
from repro_torch.kernels import causal_conv as cc  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")

TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(B=2, S=64, H=4, G=1, P=16, N=16, seed=0):
    """Model layout, drawn as tests/test_ssm.py:_inputs draws them."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(r.standard_normal((B, S, H)), 0.0).astype(np.float32)
    A = (-np.exp(r.standard_normal(H) * 0.5)).astype(np.float32)
    Bi = (r.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    Ci = (r.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bi, Ci


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(a_torch, b_jax, **tol):
    np.testing.assert_allclose(a_torch.detach().float().numpy(), np.asarray(b_jax, np.float32),
                               **(tol or TOL))


@pytest.mark.parametrize("S,chunk", [(64, 16), (37, 16), (128, 128), (16, 64)])
def test_ssd_chunked_matches_jax_chunked_and_recurrence(S, chunk):
    arrays = _inputs(S=S)
    chunk = min(chunk, S)
    y, h = tssm.ssd_chunked(*_t(*arrays), chunk=chunk)
    yj, hj = jax.jit(jssm.ssd_chunked, static_argnums=5)(*_j(*arrays), chunk)
    _close(y, yj)
    _close(h, hj)
    x, dt, A, Bi, Ci = arrays
    yr, hr = jax.jit(jax_ssd_ref)(*_j(np.moveaxis(x, 1, 2), np.moveaxis(dt, 1, 2), A,
                                      np.moveaxis(Bi, 1, 2), np.moveaxis(Ci, 1, 2)))
    _close(y, jnp.moveaxis(yr, 1, 2))
    _close(h, hr)


def test_ssd_initial_state_carries():
    """Splitting a sequence in half and carrying the state == full run."""
    x, dt, A, Bi, Ci = _t(*_inputs(S=64))
    y_full, h_full = tssm.ssd_chunked(x, dt, A, Bi, Ci, chunk=16)
    y1, h1 = tssm.ssd_chunked(x[:, :32], dt[:, :32], A, Bi[:, :32], Ci[:, :32], chunk=16)
    y2, h2 = tssm.ssd_chunked(x[:, 32:], dt[:, 32:], A, Bi[:, 32:], Ci[:, 32:], chunk=16, h0=h1)
    _close(y1, y_full[:, :32].numpy())
    _close(y2, y_full[:, 32:].numpy())
    _close(h2, h_full.numpy())


def test_decode_steps_match_full_sequence_and_jax():
    arrays = _inputs(B=1, S=8, H=2, P=8, N=8)
    x, dt, A, Bi, Ci = _t(*arrays)
    xj, dtj, Aj, Bj, Cj = _j(*arrays)
    y_full, h_full = tssm.ssd_chunked(x, dt, A, Bi, Ci, chunk=8)
    h = torch.zeros(1, 2, 8, 8)
    hj = jnp.zeros((1, 2, 8, 8), jnp.float32)
    step_j = jax.jit(jssm.ssd_decode_step)
    for t in range(8):
        y_t, h = tssm.ssd_decode_step(h, x[:, t], dt[:, t], A, Bi[:, t], Ci[:, t])
        yj_t, hj = step_j(hj, xj[:, t], dtj[:, t], Aj, Bj[:, t], Cj[:, t])
        _close(y_t, y_full[:, t].numpy())
        _close(y_t, yj_t)
        _close(h, hj)
    _close(h, h_full.numpy())


def test_causal_conv_and_step_match_jax():
    r = np.random.default_rng(7)
    x = r.standard_normal((2, 9, 6)).astype(np.float32)
    w = (r.standard_normal((4, 6)) * 0.5).astype(np.float32)
    b = (r.standard_normal(6) * 0.1).astype(np.float32)
    _close(tssm.causal_conv(*_t(x, w, b)), jssm.causal_conv(*_j(x, w, b)), atol=1e-6, rtol=0)
    state = r.standard_normal((2, 3, 6)).astype(np.float32)
    out, new = tssm.causal_conv_step(*_t(state, x[:, 0], w, b))
    out_j, new_j = jssm.causal_conv_step(*_j(state, x[:, 0], w, b))
    _close(out, out_j, atol=1e-6, rtol=0)
    _close(new, new_j, atol=0, rtol=0)
    # stepping through the sequence from a zero state == the causal conv
    state = torch.zeros(2, 3, 6)
    full = tssm.causal_conv(*_t(x, w, b))
    for t in range(x.shape[1]):
        out, state = tssm.causal_conv_step(state, torch.from_numpy(x[:, t]), *_t(w, b))
        _close(out, full[:, t].numpy(), atol=1e-6, rtol=0)


def _block_params(cfg, seed):
    """One layer's Mamba-2 parameters (float32, numpy), with every leaf
    non-trivial so that no term of the block can hide."""
    s, D = cfg.ssm, cfg.d_model
    di, nh, GN, W = s.d_inner(D), s.n_heads(D), s.n_groups * s.d_state, s.conv_width
    r = np.random.default_rng(seed)
    n = lambda *shape, scale=1.0: (r.standard_normal(shape) * scale).astype(np.float32)  # noqa: E731
    return {
        "w_z": n(D, di, scale=D ** -0.5), "w_x": n(D, di, scale=D ** -0.5),
        "w_B": n(D, GN, scale=D ** -0.5), "w_C": n(D, GN, scale=D ** -0.5),
        "w_dt": n(D, nh, scale=D ** -0.5), "dt_bias": n(nh, scale=0.5) - 2.0,
        "a_log": n(nh, scale=0.5), "d_skip": 1.0 + n(nh, scale=0.1),
        "conv_w": n(W, di, scale=0.5), "conv_b": n(di, scale=0.1),
        "conv_wB": n(W, GN, scale=0.5), "conv_bB": n(GN, scale=0.1),
        "conv_wC": n(W, GN, scale=0.5), "conv_bC": n(GN, scale=0.1),
        "norm": n(di, scale=0.1), "w_out": n(di, D, scale=di ** -0.5),
    }


def test_mamba_block_prefill_and_decode_match_jax():
    arch = "mamba2-1.3b"
    cfg_j, cfg_t = jax_get_config(arch).reduced(), get_config(arch).reduced()
    p = _block_params(cfg_t, seed=8)
    p_t = {k: torch.from_numpy(v) for k, v in p.items()}
    p_j = {k: jnp.asarray(v) for k, v in p.items()}
    r = np.random.default_rng(9)
    S = 21                                  # ragged against the chunk of 16
    u = r.standard_normal((2, S + 1, cfg_t.d_model)).astype(np.float32)

    out, (h, conv) = tssm.mamba_block(torch.from_numpy(u[:, :S]), p_t, cfg_t)
    prefill_j = jax.jit(lambda u, p: jssm.mamba_block(u, p, cfg_j))
    out_j, (hj, conv_j) = prefill_j(jnp.asarray(u[:, :S]), p_j)
    _close(out, out_j)
    _close(h, hj)
    _close(conv, conv_j)       # the raw projections: float32 matmul rounding
    assert conv.dtype == torch.float32 and h.dtype == torch.float32

    # one decode step from JAX's prefill state, in both frameworks
    u_new = u[:, S:]
    dec_t, (h2, conv2) = tssm.mamba_block(torch.from_numpy(u_new), p_t, cfg_t,
                                          h0=torch.from_numpy(np.array(hj)),
                                          conv0=torch.from_numpy(np.array(conv_j)),
                                          decode=True)
    decode_j = jax.jit(lambda u, p, h0, c0: jssm.mamba_block(u, p, cfg_j, h0=h0, conv0=c0,
                                                             decode=True))
    dec_j, (h2j, conv2j) = decode_j(jnp.asarray(u_new), p_j, hj, conv_j)
    _close(dec_t, dec_j)
    _close(h2, h2j)
    _close(conv2, conv2j)
    # and the decode step continues the prefill: the last row of a prefill
    # over S + 1 positions
    full, _ = tssm.mamba_block(torch.from_numpy(u), p_t, cfg_t)
    _close(dec_t[:, 0], full[:, S].numpy())


# ------------------------------------------------------------------- K4's route
def _conv_silu_before_k4(x, w, b):
    """The prefill's conv and SiLU as the block ran them before K4, copied
    as they were: ``causal_conv`` (the pad, W shifted products and sums,
    the bias), then the block's SiLU through float32."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + xp[:, i:i + S] * w[i]
    out = out + b
    return F.silu(out.float()).to(x.dtype)


def _conv_inputs(B, S, C, W, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, S, C, generator=g).to(dtype),
            (torch.randn(W, C, generator=g) * 0.5).to(dtype),
            (torch.randn(C, generator=g) * 0.1).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,W", [(9, 4), (2, 4), (1, 4), (7, 3), (5, 1)])
def test_causal_conv_silu_plain_is_the_code_it_replaced(S, W, dtype):
    x, w, b = _conv_inputs(2, S, 24, W, dtype)
    want = _conv_silu_before_k4(x, w, b)
    assert torch.equal(cc.causal_conv_silu_plain(x, w, b), want)
    assert torch.equal(F.silu(tssm.causal_conv(x, w, b).float()).to(dtype), want)
    # the wrapper runs it on CPU tensors, part by part, and launches nothing
    x2, w2, b2 = _conv_inputs(2, S, 8, W, dtype, seed=1)
    before = cc.causal_conv_silu.launches
    got = cc.causal_conv_silu([(x, w, b), (x2, w2, b2)])
    assert torch.equal(got[0], want) and torch.equal(got[1], _conv_silu_before_k4(x2, w2, b2))
    assert cc.causal_conv_silu.launches == before


def _parts(dtype=torch.bfloat16, W=4, channels=(64, 16, 16), w_dtype=None):
    parts = [_conv_inputs(2, 5, C, W, dtype) for C in channels]
    return [(x, w.to(w_dtype or dtype), b.to(w_dtype or dtype)) for x, w, b in parts]


def test_k4_refusal_gives_each_reason(monkeypatch):
    with torch.no_grad():
        assert tssm.k4_refusal(_parts()) == "not on a CUDA card"
    monkeypatch.setattr(tssm, "_on_card", lambda *t: True)
    with torch.no_grad():
        assert tssm.k4_refusal(_parts()) is None
        assert tssm.k4_refusal(_parts(channels=(128, 16, 16))) is None
        assert tssm.k4_refusal(_parts(W=2)) is None
        assert tssm.k4_refusal(_parts(dtype=torch.float32)) == "dtype"
        assert tssm.k4_refusal(_parts(w_dtype=torch.float32)) == "dtype"
        assert tssm.k4_refusal(_parts(W=5)) == "width"
        assert tssm.k4_refusal(_parts(channels=(60, 16, 16))) == "channels"
        assert tssm.k4_refusal(_parts(channels=(64, 16, 12))) == "channels"
    assert tssm.k4_refusal(_parts()) == "a gradient is wanted"


def test_the_wrapper_refuses_what_k4_does_not_take():
    x, w, b = _conv_inputs(2, 5, 16, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="1 to 3"):
        cc.causal_conv_silu([(x, w, b)] * 4)
    with pytest.raises(ValueError, match="shape mismatch"):
        cc.causal_conv_silu([(x, w, b), (x[:, :4], w, b)])
    with pytest.raises(ValueError, match="shape mismatch"):
        cc.causal_conv_silu([(x, w, b), (x, w[:3], b)])
    with pytest.raises(ValueError, match="shape mismatch"):
        cc.causal_conv_silu([(x, w, b[:8])])
    with pytest.raises(RuntimeError, match="no backward"):
        cc.causal_conv_silu([(x.float().requires_grad_(), w.float(), b.float())])
    with pytest.raises(ValueError, match="no K4 kernel"):
        cc._launch([x], [w], [b])


MESH = r"""
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.kernels import causal_conv as cc
from repro_torch.launch.mesh import fake_process_group
from repro_torch.models import ssm

ssm._on_card = lambda *t: True
with fake_process_group(2):
    mesh = init_device_mesh("cpu", (2,))
    x, w, b = (torch.zeros(s, dtype=torch.bfloat16) for s in ((2, 5, 16), (4, 16), (16,)))
    xd = DTensor.from_local(x, mesh, [Replicate()])
    with torch.no_grad():
        print(ssm.k4_refusal([(xd, w, b)]))
    try:
        cc.causal_conv_silu([(xd, w, b)])
    except ValueError as e:
        print(e)
"""


def test_a_mesh_stays_on_the_plain_path():
    res = subprocess.run([sys.executable, "-c", MESH], env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split("\n")[-3:-1] == ["a DTensor (a mesh)",
                                             "K4 takes plain tensors, not DTensors"]


def _spans_of_a_prefill(cfg, p, u):
    scope.clear()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        out, _ = tssm.mamba_block(u, p, cfg)
    spans = scope.spans()
    scope.clear()
    return out, spans


def test_the_conv_span_notes_the_route_and_k4_its_shape(monkeypatch):
    """On the CPU the prefill's ``conv`` span notes the plain route and why;
    with the card's check forced, the route through K4's wrapper (its plain
    version on the CPU) gives the same bits, the span notes ``impl="k4"``
    and a ``k4`` span inside it the call's rows, channels, width and item
    size."""
    cfg = get_config("mamba2-1.3b").reduced()
    s = cfg.ssm
    di, GN = s.d_inner(cfg.d_model), s.n_groups * s.d_state
    p = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in _block_params(cfg, 3).items()}
    u = torch.randn(2, 11, cfg.d_model, generator=torch.Generator().manual_seed(4))
    u = u.to(torch.bfloat16)
    plain, spans = _spans_of_a_prefill(cfg, p, u)
    conv = [sp for sp in spans if sp.tag == "conv"]
    assert [sp.attrs for sp in conv] == [{"impl": "plain", "why": "not on a CUDA card"}]
    assert not [sp for sp in spans if sp.tag == "k4"]
    monkeypatch.setattr(tssm, "_on_card", lambda *t: True)
    routed, spans = _spans_of_a_prefill(cfg, p, u)
    assert torch.equal(routed, plain)
    conv = [sp for sp in spans if sp.tag == "conv"]
    k4 = [sp for sp in spans if sp.tag == "k4"]
    assert [sp.attrs for sp in conv] == [{"impl": "k4"}]
    assert [sp.attrs for sp in k4] == [dict(rows=2 * 11, channels=di + 2 * GN,
                                            width=s.conv_width, itemsize=2)]
    assert k4[0].parent == conv[0].id


@pytest.mark.parametrize("shape,W,itemsize", [((4, 32_768, 4_352), 4, 2),
                                               ((4, 32_768, 8_448), 4, 2),
                                               ((64, 1_024, 4_352), 4, 2),
                                               ((2, 7, 24), 3, 4)])
def test_k4_work_counts_each_value_once(shape, W, itemsize):
    B, S, C = shape
    flops, nbytes = cc.work(shape, W, itemsize)
    assert nbytes == 2 * B * S * C * itemsize + (W + 1) * C * itemsize
    assert flops == B * S * C * (2 * W + 1)
    if shape == (4, 32_768, 4_352):       # 2.28 GB a mamba2 longdoc layer
        assert round(nbytes / 1e9, 2) == 2.28
    if shape == (4, 32_768, 8_448):       # 4.43 GB a granite longdoc layer
        assert round(nbytes / 1e9, 2) == 4.43
