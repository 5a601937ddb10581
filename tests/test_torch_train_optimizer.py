"""Port parity for ``repro_torch.train.optimizer``: AdamW, the schedule and
the global norm.

The cases of tests/test_optimizer.py run on the port (its ZeRO-1 spec case
waits for the sharding slice: the port's state is single-device).  Then
the port against ``repro.train.optimizer`` on trees drawn once in NumPy
and fed to both: ``schedule`` over warmup, decay and the end, ``global_norm``,
``init_opt_state`` and one and three ``apply_updates`` steps with the
master on and off, clipping on and off and fp32 or int8 state.  float32
values at rtol 1e-6 / atol 1e-7 (both evaluate the same float32 formulas
in the same order), int8 codes exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.train import optimizer as jax_opt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.tree import items  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-7)


# ------------------------------------------------ tests/test_optimizer.py
def test_adamw_minimizes_quadratic():
    cfg = opt.OptimizerConfig(learning_rate=0.1, warmup_steps=0, total_steps=200,
                              weight_decay=0.0, clip_norm=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init_opt_state(params, cfg)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}           # d/dw ||w||^2
        params, state, m = opt.apply_updates(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.2


def test_schedule_warmup_and_decay():
    cfg = opt.OptimizerConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100,
                              min_lr_ratio=0.1)
    lr5, lr10, lr100 = (float(opt.schedule(s, cfg)) for s in (5, 10, 100))
    assert lr5 < lr10
    assert abs(lr10 - 1e-3) < 1e-9
    assert abs(lr100 - 1e-4) < 1e-6


def test_clipping_bounds_update():
    cfg = opt.OptimizerConfig(learning_rate=1.0, warmup_steps=0, clip_norm=1.0,
                              weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = opt.init_opt_state(params, cfg)
    _, _, metrics = opt.apply_updates(params, {"w": torch.full((4,), 1e6)}, state, cfg)
    assert float(metrics["grad_norm"]) > 1e5   # raw norm reported


def test_step_counter_increments():
    cfg = opt.OptimizerConfig()
    params = {"w": torch.ones(2)}
    state = opt.init_opt_state(params, cfg)
    _, state, _ = opt.apply_updates(params, {"w": torch.ones(2)}, state, cfg)
    _, state, _ = opt.apply_updates(params, {"w": torch.ones(2)}, state, cfg)
    assert int(state["step"]) == 2 and state["step"].dtype == torch.int32


def test_apply_updates_leaves_its_inputs_and_apply_updates_writes_in_place():
    cfg = opt.OptimizerConfig(warmup_steps=0)
    params = {"w": torch.ones(300)}
    state = opt.init_opt_state(params, cfg)
    new_p, new_s, _ = opt.apply_updates(params, {"w": torch.ones(300)}, state, cfg)
    assert torch.equal(params["w"], torch.ones(300)) and int(state["step"]) == 0
    w = params["w"]
    opt.apply_updates_(params, {"w": torch.ones(300)}, state, cfg)
    assert params["w"] is w and torch.equal(w, new_p["w"])
    assert torch.equal(state["master"]["w"], new_s["master"]["w"])


# ------------------------------------------------------- parity with JAX
def _tree(seed):
    """A parameter tree with leaves of several sizes: 2,100 elements (8 int8
    blocks and a ragged ninth), 3,072 small ones (12 whole blocks), 5 and 1
    (less than a block)."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 700)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32),
                  "d": (rng.standard_normal((64, 48)) * 1e-3).astype(np.float32)},
            "e": rng.standard_normal((1,)).astype(np.float32)}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, key):
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, key
    if g.dtype == np.int8:
        np.testing.assert_array_equal(g, w, err_msg=key)
    else:
        np.testing.assert_allclose(g, w, err_msg=key, **TOL)


def _same(port_tree, jax_tree):
    got = dict(items(jax.tree.map(lambda t: t.numpy(), port_tree)))
    want = dict(items(jax.tree.map(np.asarray, jax_tree)))
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], key)


def test_schedule_matches_jax():
    cfg = dict(learning_rate=3e-4, warmup_steps=7, total_steps=50, min_lr_ratio=0.1)
    for step in (0, 1, 3, 7, 8, 20, 49, 50, 80):
        got = float(opt.schedule(step, opt.OptimizerConfig(**cfg)))
        want = float(jax_opt.schedule(jnp.int32(step), jax_opt.OptimizerConfig(**cfg)))
        assert abs(got - want) <= 1e-6 * abs(want) + 1e-12, step


def test_global_norm_matches_jax():
    tree = _tree(3)
    got = float(opt.global_norm(_to_torch(tree)))
    want = float(jax_opt.global_norm(jax.tree.map(jnp.asarray, tree)))
    assert abs(got - want) <= 1e-6 * want


@pytest.mark.parametrize("state_bits", [32, 8])
@pytest.mark.parametrize("use_master", [True, False])
@pytest.mark.parametrize("clip_norm", [0.0, 1.0])
def test_init_and_updates_match_jax(state_bits, use_master, clip_norm):
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10, state_bits=state_bits,
              use_master=use_master, clip_norm=clip_norm)
    cfg, jcfg = opt.OptimizerConfig(**kw), jax_opt.OptimizerConfig(**kw)
    params = _tree(0)
    p_t, p_j = _to_torch(params), jax.tree.map(jnp.asarray, params)
    s_t, s_j = opt.init_opt_state(p_t, cfg), jax_opt.init_opt_state(p_j, None, jcfg)
    _same(s_t, s_j)
    for step in range(3):
        grads = jax.tree.map(lambda a: a * 0.5, _tree(10 + step))   # the clip engages at 1.0
        p_t, s_t, m_t = opt.apply_updates(p_t, _to_torch(grads), s_t, cfg)
        p_j, s_j, m_j = jax_opt.apply_updates(p_j, jax.tree.map(jnp.asarray, grads), s_j, jcfg)
        for key in ("lr", "grad_norm"):
            _close(m_t[key].numpy(), np.asarray(m_j[key]), key)
        if step in (0, 2):                        # after one and three steps
            _same(p_t, p_j)
            _same(s_t, s_j)


def test_q8_update_slices_hold_whole_blocks(monkeypatch):
    """A leaf updated in several slices (a slice of 512 elements here) gives
    the state and parameters of one whole-leaf update, bit for bit."""
    cfg = opt.OptimizerConfig(warmup_steps=0, state_bits=8)
    params = _to_torch({"w": np.random.default_rng(1).standard_normal((7, 300)).astype(
        np.float32)})
    grads = _to_torch({"w": np.random.default_rng(2).standard_normal((7, 300)).astype(
        np.float32)})
    whole = opt.apply_updates(params, grads, opt.init_opt_state(params, cfg), cfg)
    monkeypatch.setattr(opt, "_SLICE", 512)
    sliced = opt.apply_updates(params, grads, opt.init_opt_state(params, cfg), cfg)
    for a, b in zip(items({"p": whole[0], "s": whole[1]}),
                    items({"p": sliced[0], "s": sliced[1]})):
        assert torch.equal(a[1], b[1]), a[0]
