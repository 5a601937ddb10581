"""Helpers of the full-width dry-run tests: the port's records of a list of
cells, each run by ``repro_torch.launch.dryrun.run_cell`` in one
subprocess (every cell starts and stops its own fake process group), and
JAX's records, made on the CPU by the JAX package's own dry run
(``PYTHONPATH=src python -m repro.launch.dryrun --arch A --shape S
[--multi-pod] --out tests/data/jax_dryrun_records.jsonl``)."""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
JAX_RECORDS = os.path.join(HERE, "data", "jax_dryrun_records.jsonl")

SCRIPT = r"""
import json, sys
from repro_torch.launch.dryrun import run_cell
for arch, shape, mesh, *accum in json.loads(sys.argv[1]):
    rec = run_cell(arch, shape, multi_pod=mesh == "2x16x16", accum=accum[0] if accum else None,
                   verbose=False)
    print(json.dumps(rec), flush=True)
"""


def port_records(cells, timeout=900):
    """{(arch, shape, mesh): the port's record} of ``cells``."""
    res = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(cells)],
                         env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
                         text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    recs = [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
    return {(r["arch"], r["shape"], r["mesh"]): r for r in recs}


def jax_record(arch, shape, mesh="16x16", accum=None):
    """JAX's record of a cell (with ``accum`` microbatches, when given)."""
    with open(JAX_RECORDS) as f:
        for line in f:
            r = json.loads(line)
            if (r["arch"], r["shape"], r["mesh"]) == (arch, shape, mesh) and (
                    accum is None or r.get("accum_steps") == accum):
                return r
    raise KeyError((arch, shape, mesh, accum))


def derived_delta(rec):
    """``analysis.parity.cell_delta`` of a record's cell at full width."""
    from repro_torch.analysis.parity import cell_delta
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch.mesh import production_mesh_shape
    from repro_torch.sharding.plan import make_abstract_mesh, make_plan
    cfg = get_config(rec["arch"])
    plan = make_plan(cfg, make_abstract_mesh(*production_mesh_shape(rec["mesh"] == "2x16x16")))
    return cell_delta(cfg, SHAPES[rec["shape"]], plan, rec.get("accum_steps") or 1)
