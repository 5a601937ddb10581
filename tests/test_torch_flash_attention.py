"""Port parity: K1, repro_torch.kernels.flash_attention, against JAX.

On the CPU the wrapper runs the kernel's plain version; it is held against
JAX ``attention_ref`` on every shape, causal, window and dtype case of
tests/test_kernels.py (atol = rtol 2e-5 for f32, 3e-2 for bf16, that
test's own), and once against the Pallas kernel in interpret mode.  The
CUDA kernel itself is held against the plain version on the card by
tests/test_torch_kernels_card.py and by chip_smoke.py.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402

KERNEL_SHAPES = [            # B, Sq, Skv, H, K, hd (tests/test_kernels.py:16-22)
    (2, 128, 128, 4, 2, 64),
    (1, 100, 100, 4, 4, 128),
    (2, 64, 64, 8, 2, 32),
    (1, 128, 256, 4, 1, 64),
    (1, 257, 129, 2, 2, 256),
]


def _qkv_hmajor(B, Sq, Skv, H, K, hd, seed):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal(s).astype(np.float32)
                 for s in ((B, H, Sq, hd), (B, K, Skv, hd), (B, K, Skv, hd)))


def _port(arrays, dtype=torch.float32, **kw):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    return fa.flash_attention_hmajor(q, k, v, **kw)


def _jax_ref(arrays, dtype=jnp.float32, **kw):
    ref = jax.jit(functools.partial(jax_attention_ref, **kw))
    return ref(*(jnp.asarray(a, dtype) for a in arrays))


@pytest.mark.parametrize("shape", KERNEL_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_k1_matches_jax_ref(shape, causal):
    arrays = _qkv_hmajor(*shape, seed=0)
    out = _port(arrays, causal=causal)
    ref = _jax_ref(arrays, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [8, 64, 200])
def test_plain_k1_sliding_window_matches_jax_ref(window):
    arrays = _qkv_hmajor(1, 128, 128, 4, 2, 64, seed=1)
    out = _port(arrays, causal=True, window=window)
    ref = _jax_ref(arrays, causal=True, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_plain_k1_bf16_matches_jax_ref():
    arrays = _qkv_hmajor(1, 128, 128, 4, 4, 64, seed=2)
    arrays = tuple(np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in arrays)
    out = _port(arrays, torch.bfloat16, causal=True)
    ref = _jax_ref(arrays, jnp.bfloat16, causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=3e-2, rtol=3e-2)


def test_plain_k1_kv_valid_matches_jax_ref():
    arrays = _qkv_hmajor(2, 40, 96, 4, 2, 16, seed=3)
    out = _port(arrays, causal=False, kv_valid=50)
    ref = _jax_ref(arrays, causal=False, kv_valid=50)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_ops_flash_matches_pallas_interpret():
    """The model-layout wrapper against the Pallas kernel in interpret mode."""
    r = np.random.default_rng(4)
    q = r.standard_normal((1, 40, 4, 16)).astype(np.float32)
    k = r.standard_normal((1, 40, 2, 16)).astype(np.float32)
    v = r.standard_normal((1, 40, 2, 16)).astype(np.float32)
    from repro.kernels.ops import flash_attention as jax_ops_flash
    ref = jax_ops_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                        window=16, interpret=True)
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=16)
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("kw", [dict(q_offset=3), dict(kv_valid_len=10),
                                dict(k_scale=1), dict(v_scale=1)])
def test_flash_dispatch_refuses_what_k1_does_not_take(kw):
    q = torch.zeros(1, 4, 2, 16)
    k = v = torch.zeros(1, 4, 2, 16)
    if "k_scale" in kw or "v_scale" in kw:
        kw = {name: torch.ones(1, 4, 2) for name in kw}
    with pytest.raises(ValueError, match="flash"):
        ta.attention(q, k, v, impl="flash", **kw)


def test_wrapper_checks_inputs():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError):
        fa.flash_attention_hmajor(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError):
        fa.flash_attention_hmajor(q, torch.zeros(1, 2, 8, 16, dtype=torch.float64),
                                  torch.zeros(1, 2, 8, 16, dtype=torch.float64))


def test_cpu_calls_never_count_a_launch():
    fa.flash_attention_hmajor.launches = 0
    arrays = _qkv_hmajor(1, 16, 16, 2, 1, 16, seed=5)
    _port(arrays, causal=True)
    ops.flash_attention(*(torch.zeros(1, 8, 2, 16) for _ in range(3)))
    assert fa.flash_attention_hmajor.launches == 0
