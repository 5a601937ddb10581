"""Port parity for the sharding plan (``repro_torch.sharding.plan``).

For every arch of ``ARCH_IDS`` on the (16, 16), (2, 16, 16) and 1x1 meshes
(``make_abstract_mesh`` in both frameworks), the port's ``make_plan`` must
equal JAX's field by field (H, K, V, kv_sharded, head_pad_overhead, fsdp),
give the same PartitionSpec entries for the logical axes of every leaf of
JAX's param specs, the same KV / SSM / conv cache specs at batch 1 and 128,
and the same ZeRO-1 optimizer-state logical axes (f32 and int8 state).
Then: DTensor placements of those specs on a fake 256-rank mesh give JAX's
shard shapes (in a subprocess, since a process group is global to its
process).
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.all_configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.mesh import make_abstract_mesh as jax_abstract_mesh  # noqa: E402
from repro.models.layers import ParamSpec as JaxParamSpec  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.sharding.plan import make_plan as jax_make_plan  # noqa: E402
from repro.train.optimizer import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.train.optimizer import opt_state_specs as jax_opt_state_specs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_abstract_mesh  # noqa: E402
from repro_torch.models.layers import ParamSpec  # noqa: E402
from repro_torch.sharding.plan import make_plan  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig, opt_state_specs  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model"))}


def _jax_leaves(tree, prefix=""):
    """[(key path, ParamSpec)] of a JAX spec pytree."""
    if isinstance(tree, JaxParamSpec):
        return [(prefix, tree)]
    return [kv for k in sorted(tree) for kv in _jax_leaves(tree[k], f"{prefix}/{k}")]


def _port_spec(s: JaxParamSpec) -> ParamSpec:
    return ParamSpec(tuple(s.shape), tuple(s.logical), s.dtype, s.init)


def _port_tree(tree):
    if isinstance(tree, JaxParamSpec):
        return _port_spec(tree)
    return {k: _port_tree(v) for k, v in tree.items()}


def _port_leaves(tree, prefix=""):
    if isinstance(tree, ParamSpec):
        return [(prefix, tree)]
    return [kv for k in sorted(tree) for kv in _port_leaves(tree[k], f"{prefix}/{k}")]


def _plans(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    jplan = jax_make_plan(jax_get_config(arch), jax_abstract_mesh(shape, axes))
    plan = make_plan(get_config(arch), make_abstract_mesh(shape, axes))
    return jplan, plan


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_matches_jax(arch, mesh_name):
    jplan, plan = _plans(arch, mesh_name)
    for field in ("H", "K", "V", "kv_sharded", "head_pad_overhead", "fsdp"):
        assert getattr(plan, field) == getattr(jplan, field), field
    assert plan.info.data_axes == tuple(jplan.info.data_axes)
    assert plan.info.model_axis == jplan.info.model_axis
    assert plan.info.num_devices == jplan.info.num_devices
    jspecs = JaxLM(jplan.cfg, jplan).param_specs()
    for path, s in _jax_leaves(jspecs):
        assert plan.spec(*s.logical) == tuple(jplan.spec(*s.logical)), (path, s.logical)
    for batch in (1, 128):
        assert plan.kv_cache_spec(batch) == tuple(jplan.kv_cache_spec(batch))
        assert plan.ssm_cache_spec(batch) == tuple(jplan.ssm_cache_spec(batch))
        assert plan.conv_cache_spec(batch) == tuple(jplan.conv_cache_spec(batch))
    for bits in (32, 8):
        jopt = jax_opt_state_specs(jspecs, jplan, JaxOptimizerConfig(state_bits=bits))
        opt = opt_state_specs(_port_tree(jspecs), plan, OptimizerConfig(state_bits=bits))
        jl, pl = _jax_leaves(jopt), _port_leaves(opt)
        assert [p for p, _ in pl] == [p for p, _ in jl]
        for (path, a), (_, b) in zip(pl, jl):
            assert (a.shape, a.logical, a.dtype) == (tuple(b.shape), tuple(b.logical),
                                                     b.dtype), (bits, path)
            assert plan.spec(*a.logical) == tuple(jplan.spec(*b.logical)), (bits, path)


def test_plan_without_mesh_is_the_one_device_plan():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        plan = make_plan(cfg)
        jplan = jax_make_plan(jax_get_config(arch), jax_abstract_mesh((1, 1), ("data", "model")))
        assert (plan.H, plan.K, plan.V, plan.fsdp) == (jplan.H, jplan.K, jplan.V, jplan.fsdp)
        assert plan.H == cfg.num_heads and plan.V % 128 == 0
        assert not plan.info.distributed


def test_placements_shard_a_dim_over_every_axis_of_its_entry():
    from torch.distributed.tensor import Replicate, Shard
    plan = make_plan(get_config("internlm2-1.8b"),
                     make_abstract_mesh((2, 16, 16), ("pod", "data", "model")))
    assert plan.spec("batch", "seq", "q_heads") == (("pod", "data"), None, "model")
    assert plan.placements("batch", "seq", "q_heads") == (Shard(0), Shard(0), Shard(2))
    assert plan.placements("seq", "embed") == (Replicate(),) * 3
    x = torch.ones(3)
    assert plan.act(x, "batch") is x               # a plain tensor is left alone


LOCAL_SHAPES = r"""
import json, sys
import torch
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import get_config
from repro_torch.launch.mesh import fake_process_group, make_mesh
from repro_torch.train.tree import tree_map
from repro_torch.models.lm import LM
from repro_torch.sharding.plan import make_plan
from repro_torch.train.data import shard_batch
out = {}
with fake_process_group(256):
    mesh = make_mesh((16, 16), ("data", "model"), "cpu")
    for arch in sys.argv[1:]:
        plan = make_plan(get_config(arch), mesh)
        lm = LM(plan.cfg, plan, device="meta")
        shapes = []
        tree_map(lambda s: shapes.append([list(s.shape), list(s.logical), list(
            distribute_tensor(torch.empty(s.shape, device="meta"), mesh,
                              plan.placements(*s.logical)).to_local().shape)]),
                  lm.param_specs())
        params = [list(p.to_local().shape) for p in lm.parameters()]
        batch = shard_batch({"tokens": torch.empty(8, 32, 64, device="meta")}, plan)
        out[arch] = {"leaves": shapes, "params": params,
                     "batch": [repr(batch["tokens"].placements),
                               list(batch["tokens"].to_local().shape)]}
print(json.dumps(out))
"""


def test_local_shapes_match_jax_shards():
    """Every leaf of internlm2-1.8b and phi3.5-moe at full width, placed by
    ``plan.placements`` on a fake 16x16 mesh: the local shard has the shape
    of JAX's shard for the same spec (``NamedSharding.shard_shape`` over the
    abstract mesh), and so do the meta model's own parameters; and
    ``shard_batch`` cuts a batch's microbatch dim over the data axis."""
    archs = ["internlm2-1.8b", "phi3.5-moe-42b-a6.6b"]
    res = subprocess.run([sys.executable, "-c", LOCAL_SHAPES, *archs],
                         env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    mesh = jax_abstract_mesh((16, 16), ("data", "model"))
    for arch in archs:
        jplan = jax_make_plan(jax_get_config(arch), mesh)
        leaves = got[arch]["leaves"]
        assert len(leaves) == len(got[arch]["params"]) > 0
        for shape, logical, local in leaves:
            sharding = jax.sharding.NamedSharding(mesh, jplan.spec(*logical))
            assert tuple(local) == tuple(sharding.shard_shape(tuple(shape))), (arch, logical)
        assert sorted(map(tuple, got[arch]["params"])) == sorted(
            tuple(local) for _, _, local in leaves)
        # shard_batch: the microbatch dim (1) over the data axis, as JAX's
        assert got[arch]["batch"] == ["(Shard(dim=1), Replicate())", [8, 2, 64]]
