"""Roofline summary table over the dry-run JSONL (§Roofline deliverable).

The port's twin of the JAX package's ``benchmarks/roofline_table.py``.  It
reads a dry-run JSONL (one record per arch, shape and mesh with its
roofline terms): by default the port's own, as
``python -m repro_torch.launch.dryrun --both-meshes --out results/dryrun_torch.jsonl``
writes it; a JAX dry run's JSONL has the same keys and reads alike.
"""
from __future__ import annotations

import json
import time

DEFAULT_PATH = "results/dryrun_torch.jsonl"


def load_records(path: str):
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    recs.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    # keep the LAST record per (arch, shape, mesh, overrides-key)
    dedup = {}
    for r in recs:
        key = (r["arch"], r["shape"], r["mesh"],
               json.dumps(r.get("overrides") or {}, sort_keys=True))
        dedup[key] = r
    return list(dedup.values())


def table_roofline(path: str = DEFAULT_PATH):
    t0 = time.perf_counter()
    recs = [r for r in load_records(path) if not r.get("overrides")]
    rows = {}
    n_ok = n_skip = n_err = 0
    for r in sorted(recs, key=lambda r: (r["mesh"], r["arch"], r["shape"])):
        key = f"{r['arch']}|{r['shape']}|{r['mesh']}"
        if r["status"] == "skipped":
            n_skip += 1
            rows[key] = "SKIP (documented)"
            continue
        if r["status"] != "ok":
            n_err += 1
            rows[key] = f"ERROR {r.get('error', '?')[:60]}"
            continue
        n_ok += 1
        t = r["roofline"]
        rows[key] = (f"dom={t['dominant'][:4]} "
                     f"c/m/x={t['compute_s']*1e3:.0f}/{t['memory_s']*1e3:.0f}/"
                     f"{t['collective_s']*1e3:.0f}ms "
                     f"useful={t['useful_flops_fraction']*100:.0f}% "
                     f"roofline={t['roofline_fraction']*100:.1f}%")
    rows["_summary"] = f"{n_ok} ok / {n_skip} skipped / {n_err} errors"
    return "roofline", (time.perf_counter() - t0) * 1e6, rows
