"""The port's dry run (``repro_torch.launch.dryrun``) against JAX's.

* The command line at full width on meta DTensors over a fake 256-rank
  process group, in a subprocess: exit 0, a record with the keys of JAX's
  record (``tests/data/jax_dryrun_records.jsonl``) but for the documented
  rename (``trace_s`` for ``lower_s``/``compile_s``) and addition
  (``device``), JAX's plan fields and argument bytes (but for the token
  ids' type), and JAX's per-device
  FLOPs for internlm2-1.8b x decode_32k.
* A long_500k cell on a full-attention arch is skipped with JAX's reason.
* Per-device FLOPs of the four reduced cells of
  ``tests/test_dryrun_multidevice.py:53-58`` against JAX's
  ``hlo.account(...).flops``, committed in
  ``tests/data/jax_reduced_cell_flops.json`` (compiling them takes JAX a
  while; the slow-marked test recomputes the file).  Two match exactly;
  the other two differ by what each explains:
    - mamba2-1.3b x decode_32k on (2, 4): XLA partitions the B and C
      projections (logical "state", replicated by the plan) and their
      depthwise conv over the model axis; DTensor keeps them replicated.
      Reduced mamba2 has D 64, G*N 16 (4 per model shard), conv width 4,
      4 layers and 2 tokens per device: per layer the port does
      2 x (2*2*64*16 - 2*2*64*4) more projection FLOPs and
      2 x (2*2*16*4 - 2*2*4*4) more conv FLOPs, 26,112 in all.
    - internlm2-1.8b x train_4k on (2, 2, 2): the microbatch of 2
      sequences does not divide the 4 data shards (pod x data).  XLA pads
      it to 4 and gives each device 1 sequence; the port keeps a dim that
      does not divide its axes replicated (``ShardingPlan.divisible``), so
      each device runs both: exactly twice JAX's FLOPs.
* Per-device FLOPs of phi3.5-moe-42b-a6.6b at full width on 16x16
  against JAX's record: train_4k equal (the experts' products recomputed
  under "dots" as JAX recomputes them, and each shard's kv head projected
  once for its two q heads, as XLA splits the product); decode_32k above
  JAX's by what the docstring of ``PHI_DECODE_DELTA`` derives.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun  # noqa: E402

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
JAX_RECORDS = os.path.join(HERE, "data", "jax_dryrun_records.jsonl")
JAX_FLOPS = os.path.join(HERE, "data", "jax_reduced_cell_flops.json")


def _jax_record(arch, shape):
    with open(JAX_RECORDS) as f:
        for line in f:
            r = json.loads(line)
            if (r["arch"], r["shape"]) == (arch, shape):
                return r
    raise KeyError((arch, shape))


def test_cli_writes_a_record_in_jax_format(tmp_path):
    out = tmp_path / "dry.jsonl"
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "internlm2-1.8b", "--shape", "decode_32k", "--out", str(out)],
                         env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "1 ok, 0 skipped (documented), 0 errors" in res.stdout
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    jrec = _jax_record("internlm2-1.8b", "decode_32k")
    assert set(rec) == (set(jrec) - {"lower_s", "compile_s"}) | {"trace_s", "device"}
    assert rec["status"] == "ok" and rec["device"] == "NVIDIA H100 80GB HBM3"
    assert set(rec["roofline"]) == set(jrec["roofline"])
    assert set(rec["memory_analysis"]) == set(jrec["memory_analysis"])
    assert set(rec["cost_analysis"]) <= set(jrec["cost_analysis"]) | {"bytes accessed"}
    assert rec["plan"] == jrec["plan"] and rec["accum_steps"] == jrec["accum_steps"]
    assert set(rec["traffic_by_tag"]) == set(jrec["traffic_by_tag"]) == {"attention_core"}
    t, jt = rec["roofline"], jrec["roofline"]
    assert t["hlo_flops"] == jt["hlo_flops"]
    assert (t["n_devices"], t["model_flops_total"]) == (jt["n_devices"], jt["model_flops_total"])
    # parameters, cache and tokens per device, as XLA's argument size: the
    # port's 8 local token ids are int64 (JAX's int32) and its position a
    # Python int (JAX's a 4-byte argument)
    assert rec["memory_analysis"]["argument_bytes"] - \
        jrec["memory_analysis"]["argument_bytes"] == 8 * 8 - (8 * 4 + 4)


# port FLOPs - JAX FLOPs for phi3.5-moe decode_32k on 16x16.  Its 8 kv
# heads stay replicated over the model axis (8 does not divide 16; 512 MiB
# of replicated kv weights is not over the limit), and under FSDP the kv
# weights' embed dim is cut over the data axes.  XLA splits the kv
# projections' contraction over the model axis (each device [8, 256] @
# [256, 1024], then an all-reduce); DTensor runs each whole on every model
# shard (its [128, 256] @ [256, 1024] is [8, 4096] @ [4096, 1024] in
# FLOPs).  Per layer, for k and v, with 8 tokens per device:
L_PHI, T_PHI, D_PHI, KV_PHI, M_PHI = 32, 8, 4096, 8 * 128, 16
PHI_DECODE_DELTA = L_PHI * 2 * (2 * T_PHI * D_PHI * KV_PHI
                                - 2 * T_PHI * (D_PHI // M_PHI) * KV_PHI)


@pytest.mark.parametrize("shape,delta", [("train_4k", 0), ("decode_32k", PHI_DECODE_DELTA)])
def test_phi35_full_width_flops_match_jax(tmp_path, shape, delta):
    out = tmp_path / "dry.jsonl"
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "phi3.5-moe-42b-a6.6b", "--shape", shape, "--out", str(out)],
                         env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    jrec = _jax_record("phi3.5-moe-42b-a6.6b", shape)
    assert rec["plan"] == jrec["plan"] and rec["accum_steps"] == jrec["accum_steps"]
    assert rec["roofline"]["hlo_flops"] - jrec["roofline"]["hlo_flops"] == delta


def test_long_context_on_full_attention_is_skipped_with_jax_reason():
    rec = dryrun.run_cell("internlm2-1.8b", "long_500k", verbose=False)
    jrec = _jax_record("internlm2-1.8b", "long_500k")
    assert rec == {k: jrec[k] for k in rec}
    assert rec["status"] == "skipped" and rec["reason"] == jrec["reason"]


PORT_FLOPS = r"""
import json, math
from repro_torch.analysis.account import account
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import fake_process_group, make_mesh
cells = json.load(open(__import__("sys").argv[1]))["cells"]
out = []
for c in cells:
    axes = ("data", "model") if len(c["mesh"]) == 2 else ("pod", "data", "model")
    with fake_process_group(math.prod(c["mesh"])):
        mesh = make_mesh(c["mesh"], axes, "cpu")
        cell = build_cell(c["arch"], c["shape"], mesh, reduced=True, accum=2)
        _, acct = account(cell.run)
    out.append({"flops": acct.flops, "collectives": sorted(acct.collective_bytes)})
print(json.dumps(out))
"""

# port FLOPs - JAX FLOPs for reduced mamba2 decode, as the module docstring
# derives it: per layer, for each of B and C, the projection (D -> G*N) and
# the width-W conv at G*N channels where XLA computes G*N / |model|
L, D, GN, GN_LOC, T_LOC, W = 4, 64, 16, 4, 2, 4
MAMBA_DELTA = L * 2 * ((2 * T_LOC * D * GN - 2 * T_LOC * D * GN_LOC)
                       + (2 * T_LOC * GN * W - 2 * T_LOC * GN_LOC * W))


def test_reduced_cells_flops_match_jax():
    with open(JAX_FLOPS) as f:
        jax_cells = json.load(f)["cells"]
    res = subprocess.run([sys.executable, "-c", PORT_FLOPS, JAX_FLOPS],
                         env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    port = json.loads(res.stdout.strip().splitlines()[-1])
    (il, phi, mamba, pod) = [(j["flops"], p["flops"]) for j, p in zip(jax_cells, port)]
    assert il[1] == il[0] and phi[1] == phi[0]
    assert mamba[1] - mamba[0] == MAMBA_DELTA
    assert pod[1] == 2 * pod[0]
    # data-parallel training all-reduces (tests/test_dryrun_multidevice.py:83-84)
    for p in (port[0], port[1], port[3]):
        assert "all-reduce" in p["collectives"]


JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
from repro.analysis.hlo import account
from repro.launch.cells import build_cell
from repro.launch.mesh import make_mesh
out = []
for c in json.load(open(sys.argv[1]))["cells"]:
    axes = ("data", "model") if len(c["mesh"]) == 2 else ("pod", "data", "model")
    mesh = make_mesh(tuple(c["mesh"]), axes)
    with mesh:
        cell = build_cell(c["arch"], c["shape"], mesh, reduced=True, accum=2)
        acct = account(cell.lower().compile().as_text())
    out.append({"arch": c["arch"], "shape": c["shape"], "mesh": c["mesh"],
                "flops": acct.flops, "collectives": sorted(acct.collective_bytes)})
print(json.dumps(out))
"""


@pytest.mark.slow
def test_jax_reduced_cell_flops_file_is_current():
    """Recompute the committed JAX numbers (JAX compiles the four cells)."""
    with open(JAX_FLOPS) as f:
        want = json.load(f)["cells"]
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT, JAX_FLOPS], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == want
