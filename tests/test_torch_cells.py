"""The port's cell builder (``repro_torch.launch.cells``) against JAX's.

* the (arch x shape) matrix, the accumulation rule and the inputs' shapes
  equal JAX's;
* whole slice: for reduced internlm2, mamba2 and phi3.5-moe, a 1x1
  ``build_cell`` prefill and decode run for real on the CPU in float32
  equal JAX's ``build_cell(...).jit_fn`` on the same NumPy weights and
  inputs, at the tolerance of ``tests/test_torch_lm_families.py``: 1e-4
  plus three times JAX's own float32 noise floor there (how far its output
  moves when every weight moves one float32 rounding step), each floor
  under ``FLOOR_CEILING``;
* a 1x1 train cell on the meta device runs the port's one-device train
  step abstractly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SHAPES as JAX_SHAPES  # noqa: E402
from repro.launch import cells as jax_cells  # noqa: E402
from repro.launch.mesh import make_abstract_mesh as jax_abstract_mesh  # noqa: E402
from repro.sharding.plan import make_plan as jax_make_plan  # noqa: E402
from repro.sharding.plan import single_device_mesh  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch.analysis.account import account  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import cells  # noqa: E402
from repro_torch.launch.mesh import make_abstract_mesh  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.sharding.plan import make_plan  # noqa: E402
from test_torch_lm_families import FLOOR_CEILING, _draw_params, _nudge  # noqa: E402

ARCHS = ["internlm2-1.8b", "mamba2-1.3b", "phi3.5-moe-42b-a6.6b"]
F32 = {"dtype": "float32"}


def test_all_cells_match_jax():
    assert cells.all_cells() == jax_cells.all_cells()
    assert cells.all_cells(include_inapplicable=True) == jax_cells.all_cells(True)


@pytest.mark.parametrize("mesh", [((16, 16), ("data", "model")),
                                  ((2, 16, 16), ("pod", "data", "model")),
                                  ((1, 1), ("data", "model")), ((2, 4), ("data", "model"))])
def test_default_accum_matches_jax(mesh):
    for name in SHAPES:
        cfg = get_config("internlm2-1.8b")
        plan = make_plan(cfg, make_abstract_mesh(*mesh))
        jplan = jax_make_plan(jax_get_config("internlm2-1.8b"), jax_abstract_mesh(*mesh))
        assert cells._default_accum(SHAPES[name], plan) == \
            jax_cells._default_accum(JAX_SHAPES[name], jplan)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape) if hasattr(tree, "shape") else tree


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "whisper-medium", "llava-next-34b"])
def test_inputs_have_jax_shapes(arch):
    """Token, frame and image inputs and the decode cache: JAX's shapes
    (the port's tokens are int64, what ``LM.forward`` indexes with)."""
    mesh = single_device_mesh()
    for name in ("prefill_32k", "decode_32k", "train_4k"):
        j = jax_cells.build_cell(arch, name, mesh, reduced=True).abstract_args
        c = cells.build_cell(arch, name, reduced=True)
        if name == "prefill_32k":
            assert _shapes(c.args) == _shapes(j[1:])
        elif name == "decode_32k":
            assert _shapes(c.args[:2]) == _shapes(j[1:3])
        else:
            assert _shapes(c.args[1]) == _shapes(j[1])
            assert c.accum_steps == jax_cells.build_cell(arch, name, mesh,
                                                         reduced=True).accum_steps


def test_inapplicable_shape_raises_as_in_jax():
    with pytest.raises(ValueError, match="inapplicable"):
        cells.build_cell("internlm2-1.8b", "long_500k")
    with pytest.raises(ValueError, match="inapplicable"):
        jax_cells.build_cell("internlm2-1.8b", "long_500k", single_device_mesh())


def test_one_device_train_cell_runs_on_meta():
    cell = cells.build_cell("internlm2-1.8b", "train_4k", reduced=True)
    (state, metrics), acct = account(cell.run)
    assert cell.kind == "train" and cell.accum_steps == 2
    assert metrics["loss"].device.type == "meta" and acct.flops > 0
    assert cell.lm.embed.device.type == "meta"


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _run_jax(jcell, p, args):
    """JAX's jitted cell on NumPy inputs (fresh arrays each call: the decode
    cell donates its cache)."""
    args = jax.tree.map(lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a, args)
    with jcell.plan.info.mesh:
        return jax.tree.map(np.asarray, jcell.jit_fn(p, *args))


@pytest.mark.parametrize("kind", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_matches_jax(arch, kind):
    jcell = jax_cells.build_cell(arch, kind, single_device_mesh(), reduced=True, overrides=F32)
    params = _draw_params(jcell.lm.param_specs())
    p32 = jax.tree.map(lambda a: a.astype(np.float32), params)
    cell = cells.build_cell(arch, kind, reduced=True, overrides=F32, device="cpu")
    params_from_jax(cell.lm, params)
    cell.lm.float()
    if kind == "prefill_32k":
        tokens, extras = cell.args
        jargs = (tokens.numpy().astype(np.int32), {k: v.numpy() for k, v in extras.items()})
        pick = lambda out: out["logits"]
    else:
        cache, token, pos = cell.args
        jargs = (_np(cache), token.numpy().astype(np.int32), pos)
        pick = lambda out: out[0]
    want = pick(_run_jax(jcell, p32, jargs))
    floor = max(float(np.abs(pick(_run_jax(jcell, _nudge(p32, seed), jargs)) - want).max())
                for seed in (7, 8))
    assert floor < FLOOR_CEILING, floor
    got = cell.run()
    got = (got["logits"] if kind == "prefill_32k" else got[0]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 + 3 * floor)


# --------------------------------------------------- the model on a real mesh
GLOO_WORKER = r"""
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.convert import jax_layout
from repro_torch.models.layers import place, torch_dtype
from repro_torch.models.lm import LM
from repro_torch.sharding.plan import make_plan
from repro_torch.train import train_step as ts
from repro_torch.train.data import shard_batch
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.tree import items, leaves, tree_map

rank, port = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=4,
                        rank=rank)
# internlm2 at 8 heads: on 1x4 each shard holds 2 q heads of one GQA group
ARCHS = ("internlm2-1.8b", "mamba2-1.3b", "phi3.5-moe-42b-a6.6b", "internlm2-1.8b@8heads")


def cfg_of(arch):
    arch, _, heads = arch.partition("@")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    if heads:
        cfg = dataclasses.replace(cfg, num_heads=int(heads[:-len("heads")]))
    if cfg.moe is not None:   # no drops: capacity is ranked per data shard, as in JAX
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    return cfg


def one_device(cfg, nudge=None):
    # the seeded weights on one device; nudge: every weight moved by one
    # float32 rounding step (x (1 +- 2**-24)), as test_torch_lm_families does
    one = LM(cfg, device="cpu", seed=3).float()
    if nudge is not None:
        signs = np.random.default_rng(nudge)
        with torch.no_grad():
            for p in one.parameters():
                p.mul_(1 + 2.0 ** -24 * torch.from_numpy(
                    signs.choice(np.array([-1, 1], np.float32), p.shape)))
    return one


def on_mesh(cfg, plan, one):
    # one's weights placed on the mesh; where the mesh pads the vocab
    # further (1x4: 512 rows), the padding is zeros
    lm = LM(cfg, plan, device="cpu").float()
    with torch.no_grad():
        for p, q in zip(lm.parameters(), one.parameters()):
            w = torch.zeros(p.shape)
            w[tuple(slice(0, n) for n in q.shape)] = q
            p.copy_(distribute_tensor(w, p.device_mesh, p.placements))
    return lm


def whole(a, b):
    # a from the mesh, cut to b's shape (its padded vocab rows or columns:
    # masked logits, zero weights)
    a = a.full_tensor() if isinstance(a, DTensor) else a
    return a[tuple(slice(0, n) for n in b.shape)]


def compare(run, cfg, plan):
    # {quantity: [error on the mesh, one device's noise floor (its largest
    # change under two nudges), the reference's largest value]}; run(lm)
    # gives {quantity: tensor}
    want = run(one_device(cfg))
    nudged = [run(one_device(cfg, seed)) for seed in (7, 8)]
    got = run(on_mesh(cfg, plan, one_device(cfg)))
    return {k: [float((whole(got[k], w) - w).abs().max()),
                max(float((n[k] - w).abs().max()) for n in nudged), float(w.abs().max())]
            for k, w in want.items()}


def logits(cfg, plan, seed):
    tok = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 16)))

    def run(lm):
        t = place(tok, plan, plan.spec("batch", "seq")) if lm.distributed else tok
        with torch.no_grad():
            return {"logits": lm(t, mode="train")["logits"]}
    return compare(run, cfg, plan)


def decode(cfg, plan, seed):
    # one decode step at pos 9 of a 16-row f32 cache of random numbers: the
    # logits and every cache leaf after the in-place write
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1)))
    start = {k: torch.from_numpy(rng.standard_normal(c.shape, dtype=np.float32)) * 0.3
             for k, c in items(LM(cfg, device="meta").cache_struct(4, 16, "float32"))}
    seq_cut = []

    def run(lm):
        cache = lm.init_cache(4, 16, "float32")
        with torch.no_grad():
            for k, c in items(cache):
                c.copy_(distribute_tensor(start[k], c.device_mesh, c.placements)
                        if lm.distributed else start[k])
            t = place(tok, plan, plan.spec("batch", None)) if lm.distributed else tok
            out, _ = lm.decode(cache, t, 9)
        if lm.distributed:   # which cache leaves the mesh cuts on their sequence
            seq_cut.extend(k for k, c in items(cache) if k.split("/")[-1] in ("k", "v")
                           and any(p.is_shard() and p.dim == c.dim() - 3 for p in c.placements))
        return {"logits": out, **dict(items(cache))}
    return compare(run, cfg, plan), sorted(seq_cut)


def train(cfg, plan, seed):
    # one step on [accum 2, 4, 16] tokens: the metrics, and every leaf of
    # m, v, the master and the params after it; eps 1e-3 keeps the step-1
    # update g / (|g| + eps) smooth where |g| sits at float32 noise
    ocfg = OptimizerConfig(learning_rate=1e-2, warmup_steps=1, eps=1e-3)
    tok = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 4, 16)))
    batch = {"tokens": tok, "labels": tok}
    facts = {}

    def run(lm):
        if not lm.distributed:
            # the state is JAX's stacked tree; a layer's slot of a leaf is
            # the parameter of that name
            state = ts.init_train_state(lm, ocfg)
            _, m = ts.make_train_step(lm, ocfg, grad_dtype="float32")(state, batch)
            names = {id(p): n for n, p in lm.named_parameters()}
            out = {}
            for key, (_, slots) in jax_layout(lm).items():
                for idx, p in slots:
                    for part in ("m", "v", "master"):
                        out[f"{part}:{names[id(p)]}"] = dict(
                            items(state["opt"][part]))[key][idx]
                    out[f"params:{names[id(p)]}"] = p.detach()
            return {"loss": m["loss"], "grad_norm": m["grad_norm"], **out}
        before = {n: p.detach().full_tensor() for n, p in lm.named_parameters()}
        lm.requires_grad_(True)
        specs = ts.train_state_specs(lm, ocfg)["opt"]
        params = ts.param_tree(lm)
        zeros = lambda s: place(torch.zeros(s.shape, dtype=torch_dtype(s.dtype)), plan,
                                plan.spec(*s.logical))
        opt = {k: tree_map(zeros, specs[k]) for k in ("m", "v", "step")}
        opt["master"] = tree_map(lambda s, p: p.detach().float().redistribute(
            p.device_mesh, plan.placements(*s.logical)), specs["master"], params)
        _, m = ts.make_sharded_train_step(lm, ocfg, grad_dtype="float32")(
            {"params": params, "opt": opt}, shard_batch(batch, plan))
        facts["moved"] = max(float((p.detach().full_tensor() - before[n]).abs().max())
                             for n, p in lm.named_parameters())
        # leaves whose state the mesh cuts over the data axis where the param is not
        facts["zero1"] = sum(any(p.is_shard() for p in s.placements) and not any(
            p.is_shard() for p in q.placements) for s, q in zip(leaves(opt["m"]), leaves(params)))
        out = {f"{part}:{k.replace('/', '.')}": t for part in ("m", "v", "master")
               for k, t in items(opt[part])}
        out.update({f"params:{k.replace('/', '.')}": t for k, t in items(params)})
        return {"loss": m["loss"], "grad_norm": m["grad_norm"], **out}
    return {**compare(run, cfg, plan), **facts}


try:
    out = {}
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        res = out["x".join(map(str, shape))] = {}
        for arch in ARCHS:
            cfg = cfg_of(arch)
            plan = make_plan(cfg, mesh)
            dec, seq_cut = decode(cfg, plan, 1)
            meta = LM(cfg, plan, device="meta")
            res[arch] = {"logits": logits(cfg, plan, 0), "decode": dec, "seq_sharded": seq_cut,
                         "kv_widening": meta._kv_widening() if meta._kv_replicated() else None}
        cfg = cfg_of("internlm2-1.8b")
        res["train"] = train(cfg, make_plan(cfg, mesh), 2)
    if rank == 0:
        print(json.dumps(out))
finally:
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo_model():
    """Four CPU processes in a gloo group, on a (2, 2) and a (1, 4)
    ("data", "model") mesh: reduced internlm2, mamba2 and phi3.5-moe
    (float32) placed by the plan against the same weights on one device."""
    import json
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", GLOO_WORKER, str(r), str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=600))
        finally:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


# the rule of tests/test_torch_lm_families.py and test_torch_train_step.py:
# atol 1e-4 plus three times one device's own change when every weight
# moves by one float32 rounding step (its noise floor; the shards sum in
# another order than one device does).  Values that are not O(1) (m and v,
# O(g) and O(g^2)) take the 1e-4 relative to their leaf's largest value,
# the loss and grad norm 1e-5 relative, as test_torch_train_step.py holds
# them.
ATOL = 1e-4
MESHES = ["2x2", "1x4"]


def _held(res, key, base=ATOL, relative=False):
    err, floor, big = res[key]
    scale = big if relative else 1.0
    assert floor < FLOOR_CEILING * scale, (key, floor, big)
    assert big > 0 and err <= base * scale + 3 * floor, (key, err, floor, big)


# internlm2 with 8 q heads over its 2 kv heads: on 1x4 a shard holds two q
# heads of one group (phi3.5-moe's case on 16x16)
MESH_ARCHS = ARCHS + ["internlm2-1.8b@8heads"]
# (weight repeat, activation repeat) of the widened kv projection on 1x4
WIDENING = {"internlm2-1.8b": [2, 1], "phi3.5-moe-42b-a6.6b": [2, 1],
            "internlm2-1.8b@8heads": [2, 2]}


def _mesh_params(archs):
    # the (2, 2) cases keep the ids they had before the (1, 4) mesh joined
    return ([pytest.param(a, "2x2", id=a) for a in archs]
            + [pytest.param(a, "1x4", id=f"{a}-1x4") for a in archs])


@pytest.mark.parametrize("arch,mesh", _mesh_params(MESH_ARCHS))
def test_sharded_model_matches_one_device(gloo_model, arch, mesh):
    """Train logits of the DTensor model on the mesh against one device.
    On 1x4 the reduced attention archs' 2 kv heads do not divide the model
    axis: their kv heads stay replicated and the kv projection is widened
    to one head per shard, then repeated for the shard's q heads (the path
    internlm2 and phi3.5-moe take on 16x16 at full width).  The 2x2 cases
    are also held at 1e-4 alone, as before the noise floor joined."""
    res = gloo_model[mesh][arch]
    _held(res["logits"], "logits")
    if mesh == "2x2":
        assert res["logits"]["logits"][0] <= ATOL, res["logits"]
    assert res["kv_widening"] == (WIDENING.get(arch) if mesh == "1x4" else None)


@pytest.mark.parametrize("arch,mesh", _mesh_params(MESH_ARCHS))
def test_sharded_decode_matches_one_device(gloo_model, arch, mesh):
    """One decode step on the mesh against one device, from the same cache:
    the logits and every cache leaf after the step's in-place write.  On
    1x4 the attention archs' kv cache is cut along its sequence over the
    model axis (the flash-decode layout), so the new row is written by the
    rank that holds position 9 and the query's heads are gathered; mamba2's
    SSM and conv states are cut on their heads and channels."""
    res = gloo_model[mesh][arch]
    want = {"logits", "ssm", "conv"} if arch == "mamba2-1.3b" else {"logits", "k", "v"}
    assert set(res["decode"]) == want
    for key in res["decode"]:
        _held(res["decode"], key)
    assert res["seq_sharded"] == (["k", "v"] if mesh == "1x4" and arch != "mamba2-1.3b"
                                  else [])


def _train_step_held(t):
    """One ZeRO-1 step on the mesh (gradients all-reduced over the data
    axis, the f32 state cut over it) against the one-device step on the
    same weights and batch: the loss, the grad norm, and every leaf of the
    first and second moments, the master and the parameters written back.
    The step moves the parameters by ~lr (1e-2), far above the tolerance,
    so a wrong write-back, shard offset or bias correction shows."""
    for key in ("loss", "grad_norm"):
        _held(t, key, base=1e-5, relative=True)
    parts = {}
    for key in t:
        if ":" in key:
            part = key.split(":")[0]
            parts[part] = parts.get(part, 0) + 1
            _held(t, key, relative=part in ("m", "v"))
    # every parameter: 4 layers x 9 leaves, the embedding, final norm and head
    assert parts == dict.fromkeys(("m", "v", "master", "params"), 4 * 9 + 3), parts
    assert t["moved"] > 50 * ATOL, t["moved"]
    assert t["zero1"] > 0


def test_sharded_train_step_matches_one_device(gloo_model):
    """``_train_step_held`` on the (2, 2) mesh, where ZeRO-1 cuts the state
    over two data ranks; also held as before the noise floor joined: the
    loss within 1e-4, the grad norm within 1e-4 relative and every entry of
    m within 1e-4 (m's largest entry above 1e-3)."""
    t = gloo_model["2x2"]["train"]
    _train_step_held(t)
    assert t["loss"][0] <= ATOL and t["grad_norm"][0] <= ATOL * t["grad_norm"][2]
    m_leaves = [v for key, v in t.items() if key.startswith("m:")]
    assert max(err for err, _, _ in m_leaves) <= ATOL
    assert max(big for _, _, big in m_leaves) > 10 * ATOL


def test_sharded_train_step_on_1x4_matches_one_device(gloo_model):
    """``_train_step_held`` on the (1, 4) mesh, where the kv projection is
    widened and its gradient flows back through the widening."""
    _train_step_held(gloo_model["1x4"]["train"])
