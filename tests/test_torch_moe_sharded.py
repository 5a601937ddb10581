"""The expert-parallel MoE path of the port (``moe_ffn_sharded``) on a real
(2, 2) mesh: four CPU processes in a gloo process group, each a rank of
``make_mesh((2, 2), ("data", "model"), "cpu")``, with the plan's FSDP flag
on (as ``tests/test_dryrun_multidevice.py:28-49`` holds JAX's).  The inputs
of that test (D 64, 8 experts, top-2, expert width 16, capacity factor 8, x
[4, 8, 64]) are drawn once in NumPy and given whole to every rank; both
gather modes must agree with the dense oracle at 1e-4, and with JAX's dense
oracle on the same arrays.  The process group lives in the worker processes
only."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
D, E, F_EXP, K = 64, 8, 16, 2

WORKER = r"""
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.sharding.plan import make_plan

rank, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=4,
                        rank=rank)
try:
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    plan = dataclasses.replace(make_plan(cfg, mesh), fsdp=True)
    m = MoEConfig(num_experts=8, top_k=2, d_ff_expert=16, capacity_factor=8.0)
    arrs = np.load(path)
    p = {k: torch.from_numpy(arrs[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    x = torch.from_numpy(arrs["x"])
    out = {"dense": moe.moe_ffn_dense(x, p, m)[0].tolist()}
    for mode in ("weights", "partial"):
        y, aux = moe.moe_ffn_sharded(x, p, m, plan, gather_mode=mode)
        out[mode] = y.tolist()
    y_auto, _ = moe.moe_ffn(x, p, m, plan)
    out["auto"] = y_auto.tolist()
    if rank == 0:
        print(json.dumps(out))
finally:
    dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    rng = np.random.default_rng(0)
    arrs = {"router": rng.standard_normal((D, E)) * 0.1,
            "w_gate": rng.standard_normal((E, D, F_EXP)) * 0.1,
            "w_up": rng.standard_normal((E, D, F_EXP)) * 0.1,
            "w_down": rng.standard_normal((E, F_EXP, D)) * 0.1,
            "x": rng.standard_normal((4, 8, D)) * 0.5}
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    path = str(tmp_path_factory.mktemp("moe") / "inputs.npz")
    np.savez(path, **arrs)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port), path],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300))
        finally:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    return arrs, {k: np.asarray(v, np.float32) for k, v in res.items()}


@pytest.mark.parametrize("mode", ["weights", "partial"])
def test_sharded_moe_matches_dense_oracle(gloo_run, mode):
    arrs, res = gloo_run
    np.testing.assert_allclose(res[mode], res["dense"], atol=1e-4, rtol=1e-4)
    moe = JaxMoEConfig(num_experts=E, top_k=K, d_ff_expert=F_EXP, capacity_factor=8.0)
    p = {k: jax.numpy.asarray(arrs[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    y_jax, _ = jax_moe.moe_ffn_dense(jax.numpy.asarray(arrs["x"]), p, moe)
    np.testing.assert_allclose(res[mode], np.asarray(y_jax), atol=1e-4, rtol=1e-4)


def test_auto_takes_the_sharded_path_on_a_mesh(gloo_run):
    _, res = gloo_run
    np.testing.assert_array_equal(res["auto"], res["weights"])
