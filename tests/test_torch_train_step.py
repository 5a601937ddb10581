"""Port parity for the train step, and checkpoints across the two frameworks.

``get_config(arch).reduced()`` in both frameworks for internlm2 (dense),
mamba2 (SSM) and phi3.5-moe (MoE: the aux loss), ``dtype="float32"`` and
f32 parameters in both.  The JAX parameter tree is drawn in NumPy from a
seed (``test_torch_lm_families._draw_params``) and carried into the port
by ``convert``; the batches are the synthetic data's, which both
frameworks draw bit for bit alike.  One and two steps of
``make_train_step`` at accum 2, with ``grad_dtype`` float32 and bfloat16:

* loss and grad_norm within 1e-5 relative plus three times JAX's own
  relative change under the nudge below: at this init grad_norm moves by
  up to 2.7e-4 relative when every weight moves by one float32 rounding
  step (internlm2; the attention scores' std of ~180 makes the softmax
  nearly one-hot), so 1e-5 alone would test rounding luck;
* every leaf of params, m and v within the ``_close`` rule of
  ``test_torch_lm_families``: atol 1e-4 plus three times JAX's own change
  when every initial weight moves by one float32 rounding step.  With
  ``grad_dtype`` bfloat16 each microbatch's gradient is rounded to bf16
  once, and a gradient entry that lies next to a rounding boundary can
  round the other way in the other framework: one bf16 step, 2**-7 of a
  value at most.  m is linear in the gradient, so its leaves get 2**-7 of
  their largest JAX value more; v is quadratic, 2**-6.  The parameters
  need no more: AdamW's update m / sqrt(v) does not change with the
  gradient's scale.

Then checkpoints: JAX trains 3 steps and saves; the port restores that
state and both train 2 more steps (losses and every leaf as above); the
port's save of the restored state equals JAX's byte for byte (manifest
keys, shapes and dtypes included); JAX restores a checkpoint the port
wrote after 2 steps, and its logits agree with the port's (atol 1e-4 plus
three times JAX's own change under the nudge).  Leaves
of bfloat16 and int8 cross in both directions.  One JAX compile per
family, shared by the module's tests.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.sharding.plan import make_plan as jax_make_plan  # noqa: E402
from repro.sharding.plan import single_device_mesh  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.train.data import SyntheticDataset as JaxDataset  # noqa: E402
from repro.train.train_step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.data import batch_to_device  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.train.train_step import (init_train_state, load_state_,  # noqa: E402
                                          make_train_step)
from repro_torch.train.tree import items  # noqa: E402
from test_torch_lm_families import _draw_params, _f32_cfg, _nudge  # noqa: E402

ARCHS = ["internlm2-1.8b", "mamba2-1.3b", "phi3.5-moe-42b-a6.6b"]
GRAD_DTYPES = ("float32", "bfloat16")
SEQ, GLOBAL_BATCH, ACCUM = 32, 4, 2      # 2 SSD chunks of the reduced 16
# AdamW's update m / (sqrt(v) + eps) is a steep function of a gradient entry
# that is about eps in size: one wo entry's gradient is -6.4e-9 in JAX and
# -1.5e-9 in the port (reduced internlm2, step 1), float32 noise of a sum
# whose terms are ~1e-2, and at eps 1e-8 their updates differ by 0.27 lr.
# At eps 1e-5 such noise moves an update by < 1e-2 lr, below the atol.
OCFG = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, eps=1e-5)
BF16_STEP = 2.0 ** -7                     # one bf16 rounding step, relative


def _jax_steps(cfg, mesh):
    """JAX's reduced LM of ``cfg`` in f32 and one jitted function that takes
    a step of the f32-gradient and the bf16-gradient train states at once
    (one compile for both)."""
    lm_j = JaxLM(_f32_cfg(cfg), jax_make_plan(cfg, mesh))
    ocfg = jax_opt.OptimizerConfig(**OCFG)
    fns = [jax_make_train_step(lm_j, ocfg, grad_dtype=gd) for gd in GRAD_DTYPES]

    def both(states, batch):
        return tuple(f(s, batch) for f, s in zip(fns, states))

    return lm_j, jax.jit(both)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


_FAMILIES = {}


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    return _family(request.param)


@pytest.fixture(scope="module")
def internlm2():
    return _family(ARCHS[0])


def _family(arch):
    """JAX's two steps from a NumPy-drawn f32 tree, for both gradient
    dtypes: the state and metrics after each step, and each leaf's float32
    noise floor (the largest change under two one-ulp nudges of the
    initial weights).  Computed once per family."""
    if arch not in _FAMILIES:
        _FAMILIES[arch] = _run_jax(arch)
    return _FAMILIES[arch]


def _run_jax(arch):
    cfg = jax_get_config(arch).reduced()
    mesh = single_device_mesh()
    lm_j, step = _jax_steps(cfg, mesh)
    params = jax.tree.map(lambda a: a.astype(np.float32), _draw_params(lm_j.param_specs()))
    ds = JaxDataset(JaxDataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=GLOBAL_BATCH, accum_steps=ACCUM), cfg)
    batches = [ds.batch(s) for s in range(5)]
    ocfg = jax_opt.OptimizerConfig(**OCFG)

    def run(p):
        p = jax.tree.map(jnp.asarray, p)
        states = tuple({"params": p, "opt": jax_opt.init_opt_state(p, None, ocfg)}
                       for _ in GRAD_DTYPES)
        out = []
        with mesh:
            for b in batches:
                res = step(states, jax.tree.map(jnp.asarray, b))
                states = tuple(s for s, _ in res)
                out.append([(_np(s), {k: float(v) for k, v in m.items()}) for s, m in res])
        return out, states

    out, _ = run(params)
    floor = {}
    for seed in (7, 8):
        nudged, _ = run(_nudge(params, seed))
        for i, per_step in enumerate(nudged):
            for g, (s, m) in enumerate(per_step):
                pairs = [(n, a, b) for (n, a), (_, b) in zip(items(out[i][g][0]), items(s))]
                pairs += [(k, out[i][g][1][k], m[k]) for k in ("loss", "grad_norm")]
                for n, a, b in pairs:
                    key = (i, g, n)
                    floor[key] = max(floor.get(key, 0.0), float(np.abs(a - b).max()))
    return dict(arch=arch, mesh=mesh, lm_j=lm_j, params=params, batches=batches, out=out,
                floor=floor)


def _port_lm(f):
    lm = LM(_f32_cfg(get_config(f["arch"]).reduced()), device="cpu", seed=1).float()
    return params_from_jax(lm, f["params"])


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _check_state(f, i, g, state):
    """The port's state after step ``i`` (gradient dtype index ``g``)
    against JAX's: params, m and v by ``_close``, with the bf16 allowance."""
    want = dict(items(f["out"][i][g][0]))
    for key, got in items(state):
        if not key.startswith(("params/", "opt/m/", "opt/v/")):
            continue
        w = want[key]
        atol = 1e-4 + 3 * f["floor"][(i, g, key)]
        if GRAD_DTYPES[g] == "bfloat16" and not key.startswith("params/"):
            atol += (1 if key.startswith("opt/m/") else 2) * BF16_STEP * float(np.abs(w).max())
        np.testing.assert_allclose(got.detach().numpy(), w, rtol=0, atol=atol,
                                   err_msg=f"{f['arch']} step {i + 1} {GRAD_DTYPES[g]} {key}")


@pytest.mark.parametrize("grad_dtype", GRAD_DTYPES)
def test_one_and_two_steps_match_jax(family, grad_dtype):
    """Step 1 from the shared initial weights, step 2 from JAX's state after
    step 1 (m, v and the step counter nonzero): at this init a step-1
    difference at the float32 floor grows to ~1% of step 2's grad_norm
    (the nearly one-hot softmax again), so each step starts from JAX's."""
    f = family
    g = GRAD_DTYPES.index(grad_dtype)
    lm = _port_lm(f)
    ocfg = OptimizerConfig(**OCFG)
    state = init_train_state(lm, ocfg)
    step = make_train_step(lm, ocfg, grad_dtype=grad_dtype)
    for i, batch in enumerate(f["batches"][:2]):
        if i:
            load_state_(state, f["out"][i - 1][g][0])
        state, m = step(state, batch_to_device(batch, "cpu"))
        want = f["out"][i][g][1]
        for key in ("loss", "grad_norm"):
            allowed = 1e-5 + 3 * f["floor"][(i, g, key)] / abs(want[key])
            assert _rel(float(m[key]), want[key]) <= allowed, (i, key, float(m[key]), want[key])
        assert _rel(float(m["lr"]), want["lr"]) <= 1e-6
        assert int(state["opt"]["step"]) == i + 1
        _check_state(f, i, g, state)
    # the model trains on the state: its parameters are the state's leaves
    leaf = "ln1" if "ln1" in state["params"]["blocks"] else "ln"
    assert (getattr(lm.blocks[1], leaf).data_ptr()
            == state["params"]["blocks"][leaf][1].data_ptr())


def test_state_from_a_jax_checkpoint_trains_on_as_jax_does(internlm2, tmp_path):
    """JAX's f32-gradient state after 3 steps, saved by JAX and restored by
    the port; both frameworks then take steps 4 and 5.  The port's save of
    the restored state equals JAX's checkpoint byte for byte."""
    f = internlm2
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jax_ckpt.save(str(jdir), 3, f["out"][2][0][0], metadata={"data_step": 3})
    lm = _port_lm(f)
    ocfg = OptimizerConfig(**OCFG)
    state = init_train_state(lm, ocfg)
    restored, man = ckpt.restore(str(jdir), 3, state)
    load_state_(state, restored)
    assert man["metadata"] == {"data_step": 3}
    ckpt.save(str(pdir), 3, state, metadata={"data_step": 3})
    files = sorted(p.name for p in (jdir / "step_3").iterdir())
    assert files == sorted(p.name for p in (pdir / "step_3").iterdir())
    for name in files:
        assert (jdir / "step_3" / name).read_bytes() == (pdir / "step_3" / name).read_bytes(), name
    step = make_train_step(lm, ocfg, grad_dtype="float32")
    for i in (3, 4):
        state, m = step(state, batch_to_device(f["batches"][i], "cpu"))
        want = f["out"][i][0][1]["loss"]
        assert _rel(float(m["loss"]), want) <= 1e-5 + 3 * f["floor"][(i, 0, "loss")] / abs(want)
        _check_state(f, i, 0, state)


def test_jax_restores_a_port_checkpoint_and_its_logits_agree(internlm2, tmp_path):
    f = internlm2
    lm = _port_lm(f)
    ocfg = OptimizerConfig(**OCFG)
    state = init_train_state(lm, ocfg)
    step = make_train_step(lm, ocfg, grad_dtype="float32")
    for batch in f["batches"][:2]:
        state, _ = step(state, batch_to_device(batch, "cpu"))
    ckpt.save(str(tmp_path), 2, state, metadata={"data_step": 2})
    target = f["out"][1][0][0]
    restored, man = jax_ckpt.restore(str(tmp_path), 2, target)
    assert man["step"] == 2 and man["metadata"] == {"data_step": 2}
    for (key, a), (_, b) in zip(items(_np(restored)), items(state)):
        np.testing.assert_array_equal(a, b.detach().numpy(), err_msg=key)
    toks = f["batches"][0]["tokens"][0]
    with f["mesh"]:
        forward = jax.jit(lambda p, t: f["lm_j"].forward(p, t, mode="train")["logits"])
        want = np.asarray(forward(restored["params"], jnp.asarray(toks)))
        floor = max(float(np.abs(np.asarray(forward(jax.tree.map(
            jnp.asarray, _nudge(_np(restored["params"]), seed)), jnp.asarray(toks))) - want).max())
            for seed in (7, 8))
    with torch.no_grad():
        got = lm.forward(torch.from_numpy(toks).long(), mode="train")["logits"].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 + 3 * floor)


def test_bf16_and_int8_leaves_cross_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 300)).astype(np.float32)
    jtree = {"w": jnp.asarray(w, jnp.bfloat16), "q": jnp.asarray(rng.integers(-127, 128, (
        5, 7)), jnp.int8), "step": jnp.int32(4), "s": jnp.asarray(w[0])}
    jax_ckpt.save(str(tmp_path / "j"), 4, jtree)
    target = {"w": torch.zeros((3, 300), dtype=torch.bfloat16),
              "q": torch.zeros((5, 7), dtype=torch.int8),
              "step": torch.zeros((), dtype=torch.int32), "s": torch.zeros(300)}
    got, man = ckpt.restore(str(tmp_path / "j"), 4, target)
    assert man["leaves"]["w"]["dtype"] == "bfloat16"
    for key, leaf in items(got):
        assert leaf.dtype == target[key].dtype
        np.testing.assert_array_equal(leaf.float().numpy(), np.asarray(jtree[key], np.float32))
    ckpt.save(str(tmp_path / "p"), 4, got)
    back, _ = jax_ckpt.restore(str(tmp_path / "p"), 4, jtree)
    for key in jtree:
        assert back[key].dtype == jtree[key].dtype
        np.testing.assert_array_equal(np.asarray(back[key]), np.asarray(jtree[key]))
