"""Port parity for the MoE FFN: ``repro_torch.models.moe`` against
``repro.models.moe`` on the same inputs.

Inputs are drawn once in NumPy from a seed and fed to both frameworks.
Every ported function is held to its JAX twin; the index-buffer path to
JAX's ``moe_ffn_sharded`` (on ``single_device_mesh()``, as
tests/test_moe.py builds it) and ``moe_ffn_dense`` for top-k 1, 2 and 4,
without capacity drops (capacity_factor 8) and with them (0.25), in f32 at
atol = rtol = 1e-4 (tests/test_moe.py:39-41).  ``lax.top_k`` and
``torch.topk`` may break a tie differently, so every draw asserts that no
two router probabilities of a token lie within 1e-6 of each other.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.sharding.plan import make_plan as jax_make_plan  # noqa: E402
from repro.sharding.plan import single_device_mesh  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)       # tests/test_moe.py:39-41
MIN_GAP = 1e-6


@pytest.fixture(scope="module")
def mesh_plan():
    mesh = single_device_mesh()
    cfg = jax_get_config("phi3.5-moe-42b-a6.6b").reduced()
    return mesh, jax_make_plan(cfg, mesh)


def _draw(seed, B=2, S=16, D=32, E=8, F=16):
    """x [B,S,D] and the expert params, as tests/test_moe.py scales them,
    with the router's probabilities checked for ties."""
    rng = np.random.default_rng(seed)
    s = 1 / np.sqrt(D)
    x = (rng.standard_normal((B, S, D)) * 0.5).astype(np.float32)
    p = {"router": (rng.standard_normal((D, E)) * s).astype(np.float32),
         "w_gate": (rng.standard_normal((E, D, F)) * s).astype(np.float32),
         "w_up": (rng.standard_normal((E, D, F)) * s).astype(np.float32),
         "w_down": (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32)}
    logits = x.reshape(-1, D).astype(np.float64) @ p["router"].astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    gaps = np.diff(np.sort(probs, axis=-1), axis=-1)
    assert gaps.min() > MIN_GAP, f"seed {seed}: router probabilities tie ({gaps.min():.2e})"
    return x, p


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()} if isinstance(
        tree, dict) else torch.from_numpy(tree.copy())


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()} if isinstance(
        tree, dict) else jnp.asarray(tree)


def _cfgs(top_k, cf, E=8, F=16):
    return (MoEConfig(num_experts=E, top_k=top_k, d_ff_expert=F, capacity_factor=cf),
            JaxMoEConfig(num_experts=E, top_k=top_k, d_ff_expert=F, capacity_factor=cf))


# (top_k, capacity_factor, seed, draw kwargs) of every f32 case held to JAX
CASES = {f"{k}-{'drops' if cf < 1 else 'no_drops'}": (k, cf, 10 + k, {})
         for k in (1, 2, 4) for cf in (8.0, 0.25)}
CASES["decode"] = (2, 1.25, 20, dict(B=4, S=1, E=16))


@pytest.fixture(scope="module")
def jax_cases(mesh_plan):
    """JAX's sharded and dense outputs of every case, from one jitted call
    (op-by-op dispatch of the eager paths takes seconds a call on the CPU,
    and one compile a case costs about as much)."""
    mesh, plan = mesh_plan
    draws = {name: _draw(seed, **kw) for name, (_, _, seed, kw) in CASES.items()}

    def all_cases(inputs):
        out = {}
        for name, (x, p) in inputs.items():
            k, cf, _, kw = CASES[name]
            mj = _cfgs(k, cf, E=kw.get("E", 8))[1]
            out[name] = (jax_moe.moe_ffn_sharded(x, p, mj, plan),
                         jax_moe.moe_ffn_dense(x, p, mj))
        return out

    with mesh:
        out = jax.jit(all_cases)({n: (_j(x), _j(p)) for n, (x, p) in draws.items()})
    return {n: (draws[n], jax.tree.map(np.asarray, o)) for n, o in out.items()}


def test_router_gates_aux_and_capacity_match_jax():
    x, p = _draw(0)
    xt = x.reshape(-1, x.shape[-1])
    probs_t = moe.router_probs(_t(xt), _t(p["router"]))
    probs_j = jax_moe.router_probs(_j(xt), _j(p["router"]))
    assert probs_t.dtype == torch.float32
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j), atol=1e-6, rtol=1e-5)
    for k in (1, 2, 4):
        for norm in (True, False):
            g_t, e_t = moe._topk_gates(probs_t, k, norm_topk=norm)
            g_j, e_j = jax_moe._topk_gates(probs_j, k, norm_topk=norm)
            np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
            np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-6, rtol=1e-5)
        aux_t = moe.load_balance_loss(probs_t, e_t, 8)
        aux_j = jax_moe.load_balance_loss(probs_j, e_j, 8)
        assert abs(float(aux_t) - float(aux_j)) < 1e-6
    for T in (1, 4, 7, 64, 4096):
        for top_k, cf in [(1, 1.25), (2, 1.25), (2, 0.25), (4, 8.0)]:
            m, mj = _cfgs(top_k, cf, E=16)
            assert moe._capacity(T, m) == jax_moe._capacity(T, mj)


def test_rank_within_expert_matches_jax():
    rng = np.random.default_rng(1)
    for P, E in [(7, 4), (64, 8), (512, 16)]:
        e = rng.integers(0, E, P).astype(np.int32)
        got = moe._rank_within_expert(torch.from_numpy(e).long(), E).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_moe._rank_within_expert(
            jnp.asarray(e), E)))


def test_rank_within_expert_unique_slots():
    e = torch.tensor([0, 1, 0, 0, 2, 1, 0])
    pos = moe._rank_within_expert(e, 4)
    assert pos.tolist() == [0, 0, 1, 2, 0, 1, 3]       # arrival order within each expert
    for ex in range(4):
        got = sorted(int(p) for p, ee in zip(pos, e) if int(ee) == ex)
        assert got == list(range(len(got)))


def test_expert_swiglu_matches_jax():
    rng = np.random.default_rng(2)
    _, p = _draw(3)
    buf = rng.standard_normal((8, 5, 32)).astype(np.float32)
    got = moe._expert_swiglu(_t(buf), _t(p))
    want = jax_moe._expert_swiglu(_j(buf), _j(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cf", [8.0, 0.25], ids=["no_drops", "drops"])
@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_index_path_matches_jax_sharded_and_dense(jax_cases, top_k, cf):
    name = f"{top_k}-{'drops' if cf < 1 else 'no_drops'}"
    (x, p), ((y_s, aux_s), (y_d, aux_d)) = jax_cases[name]
    m, _ = _cfgs(top_k, cf)
    y_i, aux_i = moe.moe_ffn_index(_t(x), _t(p), m)
    y_o, aux_o = moe.moe_ffn_dense(_t(x), _t(p), m)
    for got in (y_i, y_o):
        np.testing.assert_allclose(got.numpy(), y_s, **TOL)
        np.testing.assert_allclose(got.numpy(), y_d, **TOL)
    for a in (aux_i, aux_o):
        np.testing.assert_allclose(float(a), float(aux_s), rtol=1e-4)
        np.testing.assert_allclose(float(a), float(aux_d), rtol=1e-4)
    # the drop case drops: some (token, k) pair found its expert's slots full
    T = x.shape[0] * x.shape[1]
    e_flat = moe._topk_gates(moe.router_probs(_t(x).reshape(T, -1), _t(p["router"])),
                             top_k)[1].reshape(-1)
    dropped = int((moe._rank_within_expert(e_flat, 8) >= moe._capacity(T, m)).sum())
    assert (dropped > 0) == (cf < 1)


def test_decode_sized_batch_has_one_slot_per_expert(jax_cases):
    """T = 4 tokens (a batch-4 decode step) at phi3.5-moe's 16 experts,
    top-2 and capacity_factor 1.25: C = 1, so two tokens that pick the same
    expert drop one of them, in both frameworks."""
    (x, p), ((y_s, aux_s), (y_d, _)) = jax_cases["decode"]
    m, _ = _cfgs(2, 1.25, E=16)
    assert moe._capacity(4, m) == 1
    e_flat = moe._topk_gates(moe.router_probs(_t(x).reshape(4, -1), _t(p["router"])),
                             2)[1].reshape(-1)
    assert int((moe._rank_within_expert(e_flat, 16) >= 1).sum()) > 0     # some pair drops
    y_i, aux_i = moe.moe_ffn_index(_t(x), _t(p), m)
    np.testing.assert_allclose(y_i.numpy(), y_s, **TOL)
    np.testing.assert_allclose(y_i.numpy(), y_d, **TOL)
    np.testing.assert_allclose(float(aux_i), float(aux_s), rtol=1e-4)


def test_bf16_index_path_close_to_jax():
    """bf16 inputs and weights: the router in f32, silu in f32 cast back, the
    combine's products in f32 and the scatter-add in bf16, as in JAX."""
    mesh = single_device_mesh()
    plan = jax_make_plan(jax_get_config("phi3.5-moe-42b-a6.6b").reduced(), mesh)
    x, p = _draw(30)
    m, mj = _cfgs(2, 1.25)
    with mesh:
        y_s, _ = jax.jit(lambda x, p: jax_moe.moe_ffn_sharded(x, p, mj, plan))(
            _j(x).astype(jnp.bfloat16), {k: v.astype(jnp.bfloat16) for k, v in _j(p).items()})
    y_i, _ = moe.moe_ffn_index(_t(x).bfloat16(), {k: v.bfloat16() for k, v in _t(p).items()}, m)
    assert y_i.dtype == torch.bfloat16
    want = np.asarray(y_s, np.float32)
    assert np.max(np.abs(y_i.float().numpy() - want)) <= 3e-2 * np.max(np.abs(want))


def test_moe_ffn_dispatches_by_impl():
    x, p = _draw(40)
    m, _ = _cfgs(2, 1.25)
    y_idx, _ = moe.moe_ffn_index(_t(x), _t(p), m)
    y_dense, _ = moe.moe_ffn_dense(_t(x), _t(p), m)
    assert torch.equal(moe.moe_ffn(_t(x), _t(p), m, impl="auto")[0], y_idx)
    assert torch.equal(moe.moe_ffn(_t(x), _t(p), m, impl="sharded")[0], y_idx)
    assert torch.equal(moe.moe_ffn(_t(x), _t(p), m, impl="dense")[0], y_dense)
    with pytest.raises(ValueError, match="moe impl"):
        moe.moe_ffn(_t(x), _t(p), m, impl="gather")
