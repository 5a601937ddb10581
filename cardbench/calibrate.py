"""Readings that a cell's limit on ``max_gap`` is set from, on the card.

    python3 cardbench/calibrate.py --workload internlm2-1.8b.longdoc \
        --seeds 11,12,13 --control-seeds 11,12 --fault-seeds 13 --out build/calib.json

In one process, for each seed: the weights drawn, the program built, one
whole cycle of the mix served at the cell's own load (every request length
once), and the check of a run on that cycle's requests: the program's
``max_gap`` (the lower reading is the largest over a dozen seeds or more)
and, on the control seeds, the float8 control's (the upper reading is the
smallest).  On the fault seeds the cycle is served once more with a decode
step that leaves its state unchanged (``faults.state_unchanged``), and its
``max_gap`` is read too.  The benchmark's own runs never run the control or
a fault.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from pathlib import Path  # noqa: E402

from cardbench import check, faults, harness, port, weights  # noqa: E402
from cardbench.traffic import sub_seed  # noqa: E402


def readings(root, workload, seeds, control_seeds, fault_seeds=(), device="cuda", log=print):
    """One reading per seed: the program's and, on a control seed, the
    control's widest gap over the sampled requests of one cycle; on a fault
    seed, the widest gap of the cycle served under the state fault."""
    import torch
    _, cfg, mix, _, _ = harness.load_cell(root, workload)
    out, warm = [], False
    for seed in seeds:
        w = weights.draw(cfg, sub_seed(seed, 0), torch.device(device))
        lm = port.build(cfg, w)
        if not warm:
            harness.warm_up(lm, cfg, mix, seed)
            warm = True
        records, cycle_s = harness.window(lm, cfg, mix, seed, 0.0)
        del lm
        control = seed in control_seeds
        t1 = time.perf_counter()
        served, ctrl = check.gaps(w, cfg, check.sample(records, mix.check_requests, seed),
                                  control=control)
        r = {"seed": seed, "max_gap": float(max(g.max() for g in served)),
             "request_max": [float(g.max()) for g in served],
             "tokens": int(sum(len(g) for g in served)),
             "served_not_reference_best": int(sum((g > 0).sum() for g in served)),
             "cycle_s": cycle_s, "check_s": time.perf_counter() - t1}
        if control:
            r["control_max_gap"] = float(max(g.max() for g in ctrl))
            r["control_request_max"] = [float(g.max()) for g in ctrl]
        if seed in fault_seeds:
            lm = port.build(cfg, w)
            with faults.state_unchanged(cfg):
                broken, _ = harness.window(lm, cfg, mix, seed, 0.0)
            del lm
            bad, _ = check.gaps(w, cfg, check.sample(broken, mix.check_requests, seed))
            r["fault_max_gap"] = float(max(g.max() for g in bad))
            r["fault_request_max"] = [float(g.max()) for g in bad]
            del broken, bad
        log(json.dumps(r))
        out.append(r)
        del w, records, served, ctrl
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    fault = {int(s) for s in args.fault_seeds.split(",") if s}
    res = readings(Path(ROOT), args.workload, seeds, control, fault,
                   log=lambda m: print(m, flush=True))
    lower = max(r["max_gap"] for r in res)
    upper = min((r["control_max_gap"] for r in res if "control_max_gap" in r), default=None)
    least_fault = min((r["fault_max_gap"] for r in res if "fault_max_gap" in r), default=None)
    summary = {"workload": args.workload, "lower": lower, "upper": upper,
               "fault": least_fault, "runs": res}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "fault": least_fault}), flush=True)


if __name__ == "__main__":
    main()
