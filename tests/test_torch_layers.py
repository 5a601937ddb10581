"""Port parity: layer numerics of repro_torch.models.layers against JAX.

Inputs are drawn once with numpy from a seed and fed to both frameworks;
everything is float32, so only the order of float32 operations differs
(atol 1e-6).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

ATOL = 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(a_torch, b_jax, atol=ATOL):
    np.testing.assert_allclose(a_torch.detach().numpy(), np.asarray(b_jax),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("shape,eps", [((2, 5, 64), 1e-6), ((3, 16), 1e-5)])
def test_rms_norm_matches_jax(shape, eps):
    r = _rng(1)
    x = r.standard_normal(shape).astype(np.float32)
    w = (0.1 * r.standard_normal(shape[-1])).astype(np.float32)
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(w), eps))


@pytest.mark.parametrize("theta,hd", [(10_000.0, 16), (1_000_000.0, 32)])
def test_apply_rope_matches_jax(theta, hd):
    r = _rng(2)
    x = r.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = (5 + np.arange(9, dtype=np.int32))[None, :]
    out = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    ref = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    # angles reach ~13 rad; sin/cos of float32 angles differ in the last ulp
    _close(out, ref, atol=5e-6)
    _close(tl.rope_freqs(hd, theta), jl.rope_freqs(hd, theta))


def test_swiglu_matches_jax():
    r = _rng(3)
    x = r.standard_normal((2, 7, 32)).astype(np.float32)
    wg, wu = (r.standard_normal((2, 32, 48)).astype(np.float32) / math.sqrt(32))
    wd = r.standard_normal((48, 32)).astype(np.float32) / math.sqrt(48)
    t = [torch.from_numpy(a) for a in (x, wg, wu, wd)]
    j = [jnp.asarray(a) for a in (x, wg, wu, wd)]
    _close(tl.swiglu(*t), jl.swiglu(*j))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    r = _rng(4)
    logits = r.standard_normal((2, 6, 136)).astype(np.float32)   # vocab 128 padded to 136
    labels = r.integers(0, 128, (2, 6)).astype(np.int32)
    mask = (r.random((2, 6)) > 0.3).astype(np.float32) if masked else None
    out = tl.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), 128,
                                mask=None if mask is None else torch.from_numpy(mask))
    ref = jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), 128,
                                mask=None if mask is None else jnp.asarray(mask))
    _close(out, ref)


@pytest.mark.parametrize("spec", [
    tl.ParamSpec((256, 64), ("vocab", "embed")),
    tl.ParamSpec((64, 4, 16), ("embed", "q_heads", "head_dim")),
    tl.ParamSpec((64,), ("embed",), init="zeros"),
    tl.ParamSpec((8, 64), ("x", "embed"), dtype="float32", init="ones"),
])
def test_init_param_shape_dtype_and_fan_in_scale(spec):
    gen = torch.Generator().manual_seed(0)
    t = tl.init_param(gen, spec, "cpu")
    jspec = jl.ParamSpec(spec.shape, spec.logical, dtype=spec.dtype, init=spec.init)
    j = jl.init_param(jax.random.PRNGKey(0), jspec)
    assert tuple(t.shape) == tuple(j.shape) == spec.shape
    assert str(t.dtype).split(".")[-1] == str(j.dtype)
    if spec.init == "zeros":
        assert not t.float().any()
    elif spec.init == "ones":
        assert bool((t == 1).all())
    else:
        fan_in = spec.shape[-2]
        std = float(t.float().std())
        # both draws have std 1/sqrt(fan_in); 1e3+ samples put it within 10%
        assert abs(std * math.sqrt(fan_in) - 1.0) < 0.1
        assert abs(float(np.asarray(j, np.float32).std()) * math.sqrt(fan_in) - 1.0) < 0.1


def test_init_tree_follows_spec_tree():
    specs = {"b": [tl.ParamSpec((4, 8), ("a", "b")), tl.ParamSpec((8,), ("b",), init="zeros")],
             "a": {"w": tl.ParamSpec((2, 3, 5), ("x", "y", "z"), dtype="float32")}}
    tree = tl.init_tree(torch.Generator().manual_seed(1), specs, "cpu")
    assert list(tree) == ["a", "b"]
    assert tree["a"]["w"].shape == (2, 3, 5) and tree["a"]["w"].dtype == torch.float32
    assert [tuple(x.shape) for x in tree["b"]] == [(4, 8), (8,)]
    assert tree["b"][0].dtype == torch.bfloat16
    again = tl.init_tree(torch.Generator().manual_seed(1), specs, "cpu")
    assert torch.equal(tree["a"]["w"], again["a"]["w"])      # seeded: reproducible
