"""The port's dry run (``repro_torch.launch.dryrun``) against JAX's.

* The command line at full width on meta DTensors over a fake 256-rank
  process group, in a subprocess: exit 0, a record with the keys of JAX's
  record (``tests/data/jax_dryrun_records.jsonl``) but for the documented
  rename (``trace_s`` for ``lower_s``/``compile_s``) and addition
  (``device``), JAX's plan fields and argument bytes (but for the token
  ids' type), and JAX's per-device
  FLOPs for internlm2-1.8b x decode_32k.
* A long_500k cell on a full-attention arch is skipped with JAX's reason.
* Per-device FLOPs of the seven reduced cells (the four of
  ``tests/test_dryrun_multidevice.py:53-58``, mamba2 train_4k on (1, 1)
  and (2, 4), and internlm2 train_4k with the int8 optimizer state on
  (2, 4)) against JAX's ``hlo.account(...).flops``, committed in
  ``tests/data/jax_reduced_cell_flops.json`` (compiling them takes JAX a
  while; the slow-marked test recomputes the file with
  ``env -u XLA_FLAGS PYTHONPATH=src python -c "$JAX_SCRIPT" FILE``).
  They are equal but for the mamba2 train cells, whose SSD
  ``analysis.parity.ssd_train_delta`` derives:
    - mamba2-1.3b x decode_32k on (2, 4): the B and C projections and
      their depthwise conv cut over the model axis, as XLA partitions
      them in serving.
    - internlm2-1.8b x train_4k on (2, 2, 2): the microbatch of 2
      sequences is padded to the 4 data shards (pod x data), as XLA pads
      it, the padding row masked out of the loss.
    - mamba2-1.3b x train_4k: K2 forward, and the plain scan rerun and
      differentiated in the backward, against XLA's three forwards (the
      reduced configs take remat "none").
    - the int8-state cell holds JAX's argument bytes.
* Per-device FLOPs of phi3.5-moe-42b-a6.6b at full width on 16x16
  against JAX's record: train_4k and decode_32k equal (the experts'
  products recomputed under "dots" as JAX recomputes them, each shard's
  kv head projected once for its two q heads, and the decode's kv
  projections split over the model axis, as XLA splits them).
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
# [256, 1024], then an all-reduce), and so does the port
# (``LM._cut_on_model``): no difference is left.
PHI_DECODE_DELTA = 0


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
from repro_torch.launch.dryrun import memory_estimate
from repro_torch.launch.mesh import fake_process_group, make_mesh
from repro_torch.train.optimizer import OptimizerConfig
cells = json.load(open(__import__("sys").argv[1]))["cells"]
out = []
for c in cells:
    axes = ("data", "model") if len(c["mesh"]) == 2 else ("pod", "data", "model")
    with fake_process_group(math.prod(c["mesh"])):
        mesh = make_mesh(c["mesh"], axes, "cpu")
        ocfg = OptimizerConfig(state_bits=c["state_bits"]) if "state_bits" in c else None
        cell = build_cell(c["arch"], c["shape"], mesh, reduced=True, accum=2, ocfg=ocfg)
        res, acct = account(cell.run, track_memory=True)
        mem = memory_estimate(cell, res, acct.peak_live_bytes)
    out.append({"flops": acct.flops, "collectives": sorted(acct.collective_bytes),
                "argument_bytes": mem["argument_bytes"]})
print(json.dumps(out))
"""


# port FLOPs - JAX FLOPs for reduced mamba2 decode on (2, 4): the B and C
# projections and their conv cut over the model axis, as XLA cuts them
MAMBA_DELTA = 0


def _reduced_delta(c):
    """parity.cell_delta of a reduced cell (remat "none": XLA's count holds
    three forwards of the SSD in a train step)."""
    import dataclasses
    from repro_torch.analysis.parity import cell_delta
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.sharding.plan import make_abstract_mesh, make_plan
    cfg = get_config(c["arch"]).reduced()
    shape = dataclasses.replace(SHAPES[c["shape"]], seq_len=64, global_batch=4)
    axes = ("data", "model") if len(c["mesh"]) == 2 else ("pod", "data", "model")
    plan = make_plan(cfg, make_abstract_mesh(c["mesh"], axes))
    return cell_delta(cfg, shape, plan, accum=2)


def test_reduced_cells_flops_match_jax():
    """Per-device FLOPs of the reduced cells equal JAX's, but for the
    mamba2 train cells' SSD, whose difference ``analysis.parity``
    derives; the pod cell's microbatch of 2 is padded to its 4 data
    shards, as XLA pads it; the int8-state cell's argument bytes equal
    JAX's but for the token ids (int64 in the port, int32 in JAX: 4 extra
    bytes for each of the [2, 1, 64] local tokens and labels)."""
    with open(JAX_FLOPS) as f:
        jax_cells = json.load(f)["cells"]
    res = subprocess.run([sys.executable, "-c", PORT_FLOPS, JAX_FLOPS],
                         env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    port = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(port) == len(jax_cells) == 7
    for j, p in zip(jax_cells, port):
        if "state_bits" in j:
            assert p["argument_bytes"] - j["argument_bytes"] == 2 * (2 * 1 * 64) * 4, (j, p)
        else:
            assert p["flops"] - j["flops"] == _reduced_delta(j), (j, p)
    assert [_reduced_delta(j) for j in jax_cells[4:6]] == [7995392.0, 1196032.0]
    (il, phi, mamba, pod) = [(j["flops"], p["flops"]) for j, p in zip(jax_cells[:4], port)]
    assert il[1] == il[0] and phi[1] == phi[0]
    assert mamba[1] - mamba[0] == MAMBA_DELTA == 0
    assert pod[1] == pod[0]
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
from repro.train.optimizer import OptimizerConfig
out = []
for c in json.load(open(sys.argv[1]))["cells"]:
    axes = ("data", "model") if len(c["mesh"]) == 2 else ("pod", "data", "model")
    mesh = make_mesh(tuple(c["mesh"]), axes)
    ocfg = OptimizerConfig(state_bits=c["state_bits"]) if "state_bits" in c else None
    with mesh:
        cell = build_cell(c["arch"], c["shape"], mesh, reduced=True, accum=2, ocfg=ocfg)
        compiled = cell.lower().compile()
        acct = account(compiled.as_text())
    rec = {"arch": c["arch"], "shape": c["shape"], "mesh": c["mesh"],
           "flops": acct.flops, "collectives": sorted(acct.collective_bytes)}
    if "state_bits" in c:
        rec["state_bits"] = c["state_bits"]
        rec["argument_bytes"] = compiled.memory_analysis().argument_size_in_bytes
    out.append(rec)
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
