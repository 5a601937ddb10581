"""Port parity: repro_torch.models.attention against repro.models.attention.

The cases of tests/test_attention.py, with inputs drawn once with numpy and
fed to both frameworks; float32 throughout, atol 1e-5 (that test's own).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as ja  # noqa: E402
from repro.models.lm import _quantize_kv as j_quantize_kv  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models.lm import _quantize_kv as t_quantize_kv  # noqa: E402

ATOL = 1e-5


def _qkv(B=2, Sq=48, Skv=48, H=4, K=2, hd=32, seed=0):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal(s).astype(np.float32)
                 for s in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)))


def _jax(fn, **kw):
    """``fn`` with its Python-valued keywords bound, jitted (one compile per
    case is cheaper than eager dispatch of every jnp op)."""
    return jax.jit(functools.partial(fn, **kw))


def _both(fn_name, arrays, **kw):
    t = getattr(ta, fn_name)(*[torch.from_numpy(a) for a in arrays], **kw)
    j = _jax(getattr(ja, fn_name), **kw)(*[jnp.asarray(a) for a in arrays])
    return t.numpy(), np.asarray(j)


@pytest.mark.parametrize("fn_name", ["attention_dot", "attention_chunked"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 9), (False, None)])
def test_matches_jax(fn_name, causal, window):
    kw = dict(causal=causal, window=window)
    if fn_name == "attention_chunked":
        kw["chunk"] = 16
    a, b = _both(fn_name, _qkv(), **kw)
    np.testing.assert_allclose(a, b, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("chunk", [7, 16, 48, 100])
def test_chunked_matches_jax_chunks(chunk):
    a, b = _both("attention_chunked", _qkv(seed=1), causal=True, window=None,
                 chunk=chunk)
    np.testing.assert_allclose(a, b, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("fn_name", ["attention_dot", "attention_chunked"])
def test_decode_q_offset_and_kv_valid_len(fn_name):
    q, k, v = _qkv(Sq=1, seed=2)
    k[:, 30:] = 999.0
    v[:, 30:] = -999.0
    kw = dict(causal=False, kv_valid_len=30, q_offset=29)
    if fn_name == "attention_chunked":
        kw["chunk"] = 20
    a, b = _both(fn_name, (q, k, v), **kw)
    np.testing.assert_allclose(a, b, atol=ATOL, rtol=ATOL)
    assert np.abs(a).max() < 10          # the invalid tail is not seen


@pytest.mark.parametrize("fn_name", ["attention_dot", "attention_chunked"])
def test_int8_scaled_kv_matches_jax(fn_name):
    q, k, v = _qkv(Sq=1, Skv=64, seed=3)
    kq_t, ks_t = t_quantize_kv(torch.from_numpy(k))
    vq_t, vs_t = t_quantize_kv(torch.from_numpy(v))
    kq_j, ks_j = j_quantize_kv(jnp.asarray(k))
    vq_j, vs_j = j_quantize_kv(jnp.asarray(v))
    np.testing.assert_array_equal(kq_t.numpy(), np.asarray(kq_j))
    np.testing.assert_array_equal(vq_t.numpy(), np.asarray(vq_j))
    np.testing.assert_allclose(ks_t.numpy(), np.asarray(ks_j), rtol=1e-7)
    kw = dict(causal=False)
    if fn_name == "attention_chunked":
        kw["chunk"] = 24
    a = getattr(ta, fn_name)(torch.from_numpy(q), kq_t, vq_t, k_scale=ks_t,
                             v_scale=vs_t, **kw).numpy()
    b = np.asarray(_jax(getattr(ja, fn_name), **kw)(jnp.asarray(q), kq_j, vq_j,
                                                     k_scale=ks_j, v_scale=vs_j))
    np.testing.assert_allclose(a, b, atol=ATOL, rtol=ATOL)
    exact = ta.attention_dot(*[torch.from_numpy(x) for x in (q, k, v)], causal=False)
    assert float((exact - torch.from_numpy(a)).abs().max()) < 0.05


def test_gqa_matches_jax_and_repeated_mha():
    q, k, v = _qkv(H=8, K=2, seed=4)
    a, b = _both("attention_dot", (q, k, v), causal=True)
    np.testing.assert_allclose(a, b, atol=ATOL, rtol=ATOL)
    rep = ta.attention_dot(torch.from_numpy(q), torch.from_numpy(np.repeat(k, 4, axis=2)),
                           torch.from_numpy(np.repeat(v, 4, axis=2)), causal=True)
    np.testing.assert_allclose(a, rep.numpy(), atol=ATOL)


@pytest.mark.parametrize("w", [-1, 8])
def test_window_as_tensor(w):
    q, k, v = _qkv(seed=5)
    t = ta.attention_chunked(*[torch.from_numpy(x) for x in (q, k, v)], causal=True,
                             window=torch.tensor(w), chunk=16).numpy()
    j = np.asarray(_jax(ja.attention_chunked, causal=True, chunk=16)(
        *[jnp.asarray(x) for x in (q, k, v)], window=jnp.int32(w)))
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("B,Sq,g,K,hd", [(1, 1, 1, 1, 8), (3, 17, 2, 3, 16),
                                         (2, 64, 4, 1, 32), (1, 33, 3, 2, 8)])
def test_random_shapes_match_jax(B, Sq, g, K, hd):
    arrays = _qkv(B=B, Sq=Sq, Skv=Sq, H=g * K, K=K, hd=hd, seed=Sq)
    a, b = _both("attention_chunked", arrays, causal=True, chunk=13)
    np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-5)
    a, b = _both("attention_dot", arrays, causal=True)
    np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-5)
