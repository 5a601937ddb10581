"""Port parity: K2, repro_torch.kernels.ssd_scan, against JAX.

On the CPU the wrapper runs the kernel's plain version (the chunked block
decomposition); it is held against JAX ``ssd_ref`` (the exact recurrence)
on every case of tests/test_kernels.py:66-101 (atol = rtol 1e-4 in f32,
5e-2 for bf16 inputs, that test's own), and once, through the model's
``ssd_chunked``, against the Pallas kernel in interpret mode.  The CUDA
kernel itself is held against the plain version on the card by
tests/test_torch_kernels_card.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ks  # noqa: E402
from repro_torch.kernels.ref import ssd_ref  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402

KERNEL_CASES = [             # B, S, H, G, P, N, chunk (tests/test_kernels.py:66-71)
    (1, 64, 4, 1, 32, 16, 16),
    (2, 37, 4, 2, 16, 32, 16),
    (1, 128, 2, 1, 64, 128, 32),
    (1, 96, 8, 4, 16, 16, 48),
]


def _softplus(a):
    return np.logaddexp(a, 0.0)


def _inputs_hmajor(B, S, H, G, P, N, seed):
    """x [B,H,S,P], dt [B,H,S], A [H], B/C [B,G,S,N], drawn as
    tests/test_kernels.py draws them (dt = softplus(normal), A < 0)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, H, S, P)).astype(np.float32)
    dt = _softplus(r.standard_normal((B, H, S))).astype(np.float32)
    A = (-np.exp(r.standard_normal(H) * 0.5)).astype(np.float32)
    Bi = (r.standard_normal((B, G, S, N)) * 0.5).astype(np.float32)
    Ci = (r.standard_normal((B, G, S, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bi, Ci


def _t(arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


@pytest.mark.parametrize("B,S,H,G,P,N,chunk", KERNEL_CASES)
def test_plain_k2_matches_jax_ssd_ref(B, S, H, G, P, N, chunk):
    arrays = _inputs_hmajor(B, S, H, G, P, N, seed=0)
    y, st = ks.ssd_scan_hmajor(*_t(arrays), chunk=chunk)
    yr, sr = jax.jit(jax_ssd_ref)(*(jnp.asarray(a) for a in arrays))
    assert y.dtype == torch.float32 and st.shape == (B, H, P, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), atol=1e-4, rtol=1e-4)


def test_plain_k2_bf16_inputs_match_jax_ssd_ref():
    """tests/test_kernels.py:88-101: x, dt, B, C in bf16, A in f32."""
    x, dt, A, Bi, Ci = _inputs_hmajor(1, 64, 2, 1, 32, 16, seed=1)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)  # noqa: E731
    x, dt, Bi, Ci = bf(x), bf(dt), bf(Bi), bf(Ci)
    y, _ = ks.ssd_scan_hmajor(*_t((x, dt), torch.bfloat16), torch.from_numpy(A),
                              *_t((Bi, Ci), torch.bfloat16), chunk=16)
    yr, _ = jax.jit(jax_ssd_ref)(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt, jnp.bfloat16),
                                 jnp.asarray(A), jnp.asarray(Bi, jnp.bfloat16),
                                 jnp.asarray(Ci, jnp.bfloat16))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yr, np.float32),
                               atol=5e-2, rtol=5e-2)


def test_port_ssd_ref_matches_jax_ssd_ref_with_h0():
    """The port's own oracle (the one tests/test_torch_kernels_card.py
    holds K2 to) against JAX's, from a non-zero initial state."""
    arrays = _inputs_hmajor(2, 20, 4, 2, 8, 16, seed=2)
    h0 = (np.random.default_rng(3).standard_normal((2, 4, 8, 16)) * 0.5).astype(np.float32)
    y, st = ssd_ref(*_t(arrays), h0=torch.from_numpy(h0))
    yr, sr = jax.jit(jax_ssd_ref)(*(jnp.asarray(a) for a in arrays), jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), atol=1e-4, rtol=1e-4)
    # and the plain K2 from the same state, at a chunk that does not divide S
    y2, st2 = ks.ssd_scan_hmajor(*_t(arrays), chunk=8, h0=torch.from_numpy(h0))
    np.testing.assert_allclose(y2.numpy(), y.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st2.numpy(), st.numpy(), atol=1e-4, rtol=1e-4)


def test_ops_ssd_scan_matches_pallas_interpret():
    """The model's ``ssd_chunked``, K2 in the model's layout, against the
    Pallas kernel in interpret mode."""
    from repro.kernels.ops import ssd_scan as jax_ops_ssd_scan
    x, dt, A, Bi, Ci = _inputs_hmajor(1, 40, 4, 2, 8, 16, seed=4)
    x, dt = np.moveaxis(x, 1, 2).copy(), np.moveaxis(dt, 1, 2).copy()   # [B,S,H,P], [B,S,H]
    Bi, Ci = np.moveaxis(Bi, 1, 2).copy(), np.moveaxis(Ci, 1, 2).copy()  # [B,S,G,N]
    yr, sr = jax_ops_ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, Bi, Ci)), chunk=16,
                              interpret=True)
    y, st = ssd_chunked(*_t((x, dt, A, Bi, Ci)), chunk=16)
    assert y.shape == x.shape and st.shape == (1, 4, 8, 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bad", ["heads_not_multiple_of_groups", "dt_shape", "A_dtype",
                                 "mixed_x_B_dtypes", "float64", "h0_shape", "no_positions"])
def test_wrapper_refuses_what_k2_does_not_take(bad):
    x, dt, A, Bi, Ci = _t(_inputs_hmajor(1, 8, 4, 2, 8, 16, seed=5))
    h0 = None
    if bad == "heads_not_multiple_of_groups":
        Bi, Ci = torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16)
    elif bad == "dt_shape":
        dt = dt[:, :, :4]
    elif bad == "A_dtype":
        A = A.to(torch.bfloat16)
    elif bad == "mixed_x_B_dtypes":
        Bi = Bi.to(torch.bfloat16)
    elif bad == "float64":
        x, Bi, Ci = x.double(), Bi.double(), Ci.double()
    elif bad == "h0_shape":
        h0 = torch.zeros(1, 4, 16, 8)
    elif bad == "no_positions":
        x, dt, Bi, Ci = x[:, :, :0], dt[:, :, :0], Bi[:, :, :0], Ci[:, :, :0]
    with pytest.raises(ValueError):
        ks.ssd_scan_hmajor(x, dt, A, Bi, Ci, chunk=4, h0=h0)


def test_cpu_calls_never_count_a_launch():
    ks.ssd_scan_hmajor.launches = 0
    arrays = _inputs_hmajor(1, 16, 2, 1, 8, 8, seed=6)
    ks.ssd_scan_hmajor(*_t(arrays), chunk=8)
    ssd_chunked(torch.zeros(1, 16, 2, 8), torch.zeros(1, 16, 2), -torch.ones(2),
                torch.zeros(1, 16, 1, 8), torch.zeros(1, 16, 1, 8), chunk=8)
    assert ks.ssd_scan_hmajor.launches == 0
