"""The port's step accounting (``analysis/account.py``), roofline terms
(``analysis/roofline.py``), fused-kernel adjustment (``analysis/variants.py``)
and the experiments-table twin.

The accounting cases are those of ``tests/test_hlo_analysis.py``: where JAX
multiplies a scan body by its trip count, the port runs the loop and counts
each matmul as it is dispatched.  The collective and sharded cases run on a
fake process group in a subprocess (a process group is global to its
process).  The tables are held to JAX's on a committed dry-run JSONL
(``tests/data/jax_dryrun_records.jsonl``: ``python -m repro.launch.dryrun``
on six cells of the 16x16 mesh).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.analysis import roofline as jax_roofline  # noqa: E402
from repro.analysis.hlo import HloAccount  # noqa: E402
from repro.analysis.variants import adjusted_memory_term as jax_adjusted  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.all_configs import ARCH_IDS  # noqa: E402
from repro.configs.base import SHAPES as JAX_SHAPES  # noqa: E402
from repro.launch.mesh import make_abstract_mesh as jax_abstract_mesh  # noqa: E402
from repro.sharding.plan import make_plan as jax_make_plan  # noqa: E402
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.analysis.account import Account, StepAccount, account  # noqa: E402
from repro_torch.core.scope import named_scope  # noqa: E402
from repro_torch.analysis.variants import adjusted_memory_term  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch.mesh import make_abstract_mesh  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.sharding.plan import make_plan  # noqa: E402

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
FIXTURE = os.path.join(HERE, "data", "jax_dryrun_records.jsonl")


def _records():
    with open(FIXTURE) as f:
        return [json.loads(line) for line in f if line.strip()]


# ------------------------------------------------------------ accounting
def test_loop_of_matmuls_counts_every_iteration():
    x, ws = torch.zeros(64, 32), torch.zeros(5, 32, 32)

    def f(x):
        for w in ws:
            x = torch.tanh(x @ w)
        return x
    _, acct = account(f, x)
    assert acct.flops == 2 * 64 * 32 * 32 * 5


def test_nested_loops_count_both_levels():
    x, ws = torch.zeros(16, 16), torch.zeros(4, 16, 16)

    def f(x):
        for _ in range(3):
            for w in ws:
                x = x @ w
        return x
    _, acct = account(f, x)
    assert acct.flops == 2 * 16 * 16 * 16 * 4 * 3


def test_unrolled_matches_analytic():
    a, b = torch.zeros(32, 64), torch.zeros(64, 64)
    _, acct = account(lambda: (a @ b) @ b)
    assert acct.flops == 2 * 32 * 64 * 64 * 2
    assert acct.traffic_bytes == 4 * (2 * (32 * 64 + 64 * 64 + 32 * 64))
    assert acct.collective_bytes == {}


def test_views_move_no_bytes_and_einsum_counts_its_products():
    a, b = torch.zeros(2, 8, 4, 16), torch.zeros(2, 8, 4, 16)
    _, acct = account(lambda: torch.einsum("bqhd,bkhd->bhqk", a, b))
    assert acct.flops == 2 * 2 * 4 * 8 * 8 * 16
    _, views = account(lambda: a.transpose(1, 2)[:, 1].unsqueeze(0))
    assert views.flops == 0 and views.traffic_bytes == 0
    _, copy = account(lambda: a.transpose(1, 2).contiguous())
    assert copy.traffic_bytes == 2 * 4 * a.numel()          # read once, written once


def test_scopes_tag_the_attention_core():
    q = torch.zeros(1, 8, 4, 16)
    with Account() as acct:
        attn.attention(q, q[:, :, :2], q[:, :, :2], impl="dot")
        attn.attention(q, q[:, :, :2], q[:, :, :2], impl="chunked", chunk=4)
    res = acct.result
    assert 0 < res.traffic_by_tag["attention_core"] <= res.traffic_bytes
    assert set(res.traffic_by_tag) == {"attention_core"}
    with Account() as outside:
        with named_scope("not_a_tag"):
            torch.zeros(3) + 1
    assert outside.result.traffic_by_tag == {}


def test_kernels_count_their_own_work_on_meta_tensors():
    from repro_torch.kernels import flash_attention as k1
    from repro_torch.kernels import ssd_scan as k2
    q = torch.empty(1, 16, 4096, 128, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(1, 8, 4096, 128, dtype=torch.bfloat16, device="meta")
    out, acct = account(lambda: k1.flash_attention_hmajor(q, kv, kv, causal=True))
    assert out.shape == q.shape and out.device.type == "meta"
    assert (acct.flops, acct.traffic_bytes) == k1.work(q.shape, (8, 4096), causal=True)
    assert acct.flops == 4 * 128 * (4096 * 4097 // 2) * 16
    assert acct.kernel_calls == {"repro_torch::flash_attention_hmajor": 1}
    x = torch.empty(1, 64, 4096, 64, dtype=torch.bfloat16, device="meta")
    dt = torch.empty(1, 64, 4096, device="meta")
    A = torch.empty(64, device="meta")
    B = torch.empty(1, 1, 4096, 128, dtype=torch.bfloat16, device="meta")
    (y, state), acct = account(lambda: k2.ssd_scan_hmajor(x, dt, A, B, B))
    assert y.shape == x.shape and tuple(state.shape) == (1, 64, 64, 128)
    assert (acct.flops, acct.traffic_bytes) == k2.work(x.shape, 1, 128)
    assert k1.flash_attention_hmajor.launches == 0 and k2.ssd_scan_hmajor.launches == 0


MESH_CASES = r"""
import json
import torch
from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor
from repro_torch.analysis.account import account
from repro_torch.launch.mesh import fake_process_group, make_mesh
out = {}
with fake_process_group(8):
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    t = distribute_tensor(torch.empty(64, 128, device="meta"), mesh, [Shard(0), Replicate()])
    _, a = account(lambda: t.redistribute(mesh, [Replicate(), Replicate()]))
    out["gather"] = a.collective_bytes
    from torch.distributed.tensor import DTensor
    p = DTensor.from_local(torch.empty(32, 16, device="meta"), mesh, [Replicate(), Partial()])
    _, a = account(lambda: p.redistribute(mesh, [Replicate(), Replicate()]))
    out["reduce"] = a.collective_bytes
with fake_process_group(256):
    mesh = make_mesh((16, 16), ("data", "model"), "cpu")
    x = distribute_tensor(torch.empty(64, 128, 2048, device="meta"), mesh, [Shard(0), Replicate()])
    w = distribute_tensor(torch.empty(2048, 8192, device="meta"), mesh, [Replicate(), Shard(1)])
    y, a = account(lambda: x @ w)
    out["matmul"] = [a.flops, list(y.to_local().shape), a.collective_bytes]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def mesh_cases():
    res = subprocess.run([sys.executable, "-c", MESH_CASES], env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_collective_bytes_are_the_local_payload(mesh_cases):
    # all-gather over data (2): max(result, operand) = the gathered [64,128]
    assert mesh_cases["gather"] == {"all-gather": 64 * 128 * 4}
    # all-reduce over model: the local [32,16] payload
    assert mesh_cases["reduce"] == {"all-reduce": 32 * 16 * 4}


def test_sharded_matmul_counts_per_device_flops(mesh_cases):
    flops, local, coll = mesh_cases["matmul"]
    assert local == [4, 128, 512]
    assert flops == 2 * (64 // 16) * 128 * 2048 * (8192 // 16)
    assert flops * 256 == 2 * 64 * 128 * 2048 * 8192
    assert coll == {}


# ------------------------------------------------------------ roofline
def test_constants_are_chosen_by_device_name():
    sxm = roofline.device_spec("NVIDIA H100 80GB HBM3")
    assert (sxm.peak_flops_bf16, sxm.hbm_bw, sxm.link_bw) == (989e12, 3.35e12, 450e9)
    pcie = roofline.device_spec("NVIDIA H100 PCIe")
    assert pcie.peak_flops_bf16 < sxm.peak_flops_bf16 and pcie.hbm_bw < sxm.hbm_bw
    assert roofline.DEFAULT_DEVICE == "NVIDIA H100 80GB HBM3"
    with pytest.raises(ValueError, match="no roofline constants"):
        roofline.device_spec("TPU v5 lite")
    with pytest.raises(ValueError):
        roofline.build_terms("x", get_config("internlm2-1.8b"), SHAPES["train_4k"], "1x1", 1,
                             StepAccount(), device="NVIDIA A100-SXM4-80GB")


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_terms_have_jax_keys_and_model_flops(shape):
    acct = StepAccount(flops=3e12, traffic_bytes=2e11, collective_bytes={"all-reduce": 5e9})
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert roofline.model_flops(cfg, SHAPES[shape]) == jax_roofline.model_flops(
            jcfg, JAX_SHAPES[shape])
    cfg, jcfg = get_config("internlm2-1.8b"), jax_get_config("internlm2-1.8b")
    t = roofline.build_terms("internlm2-1.8b", cfg, SHAPES[shape], "16x16", 256, acct, 7.0)
    j = jax_roofline.build_terms("internlm2-1.8b", jcfg, JAX_SHAPES[shape], "16x16", 256,
                                 HloAccount(flops=3e12, traffic_bytes=2e11,
                                            collective_bytes={"all-reduce": 5e9}), {"flops": 3e12})
    d, jd = t.to_dict(), j.to_dict()
    assert set(d) == set(jd)
    assert d["compute_s"] == 3e12 / 989e12 and d["memory_s"] == 2e11 / 3.35e12
    assert d["collective_s"] == 5e9 / 450e9 and d["device_bytes_peak"] == 7.0
    for key in ("hlo_flops", "hbm_bytes", "collective_bytes", "model_flops_total", "n_devices"):
        assert d[key] == jd[key], key
    assert d["roofline_fraction"] == t.fraction_at(t.step_time_s)


# ------------------------------------------------------------ tables
def _jax_plan(r):
    shape = (2, 16, 16) if r["mesh"] == "2x16x16" else (16, 16)
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return jax_make_plan(jax_get_config(r["arch"]), jax_abstract_mesh(shape, axes))


def test_adjusted_memory_term_matches_jax():
    recs = [r for r in _records() if r["status"] == "ok"]
    assert {t for r in recs for t in r["traffic_by_tag"]} == {"attention_core", "ssd_core"}
    for r in recs:
        want = jax_adjusted(r, _jax_plan(r), jax_get_config(r["arch"]), JAX_SHAPES[r["shape"]])
        plan = make_plan(get_config(r["arch"]), make_abstract_mesh(
            *(((2, 16, 16), ("pod", "data", "model")) if r["mesh"] == "2x16x16"
              else ((16, 16), ("data", "model")))))
        got = adjusted_memory_term(r, plan, get_config(r["arch"]), SHAPES[r["shape"]])
        for key in ("hbm_bytes", "removed_bytes", "added_bytes"):
            assert got[key] == want[key], (r["arch"], r["shape"], key)
        assert got["memory_s"] == got["hbm_bytes"] / 3.35e12
        assert want["memory_s"] == want["hbm_bytes"] / jax_roofline.HBM_BW


def test_experiments_table_twin_prints_jax_table(capsys):
    from benchmarks import gen_experiments_table as jax_table
    from repro_torch.benchmarks import gen_experiments_table as table
    jax_table.main(FIXTURE)
    want = capsys.readouterr().out
    table.main(FIXTURE)
    got = capsys.readouterr().out
    assert got == want and "SKIP (full attention @500k)" in got
    for r in _records():
        if r["status"] == "ok":
            adj = table.fused_adjust(r)
            assert adj["hbm_bytes"] == jax_adjusted(
                r, _jax_plan(r), jax_get_config(r["arch"]), JAX_SHAPES[r["shape"]])["hbm_bytes"]


def test_roofline_table_reads_the_ports_own_jsonl_by_default():
    import inspect
    from repro_torch.benchmarks import roofline_table
    assert roofline_table.DEFAULT_PATH == "results/dryrun_torch.jsonl"
    assert inspect.signature(roofline_table.table_roofline).parameters["path"].default == \
        roofline_table.DEFAULT_PATH
    assert "no dry run of its own" not in roofline_table.__doc__


def test_terms_dataclass_mirrors_jax_fields():
    jf = [f.name for f in dataclasses.fields(jax_roofline.RooflineTerms)]
    pf = [f.name for f in dataclasses.fields(roofline.RooflineTerms)]
    assert pf == jf + ["device"]
