"""Port parity: the Mamba-2 block, repro_torch.models.ssm, against JAX.

Inputs are drawn once with numpy from a seed and fed to both frameworks,
in float32, at the tolerance of tests/test_ssm.py (atol = rtol 1e-4):

* ``ssd_chunked`` against JAX ``ssd_chunked`` and ``ssd_ref`` on the cases
  of tests/test_ssm.py:24-34, the state carried over a split sequence
  (:37-50) and chained decode steps (:53-61);
* ``causal_conv`` and ``causal_conv_step``;
* ``mamba_block`` prefill and decode on the same parameters.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

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
