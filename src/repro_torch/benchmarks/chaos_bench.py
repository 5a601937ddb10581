"""Chaos-robustness harness: runs the `chaos_robustness` sweep, writes a
JSON point (BENCH_chaos.json), and gates CI on its acceptance claims.

    PYTHONPATH=src python -m repro_torch.benchmarks.chaos_bench [--quick]
        [--out build/bench/BENCH_chaos.json] [--check]
        [--check-baseline BENCH_chaos.json] [--seed N]

The port's twin of the JAX package's ``benchmarks/chaos_bench.py``, over
the port's ``paper_tables`` (host only; no card).

Checks (``--check``, implied by ``--check-baseline``):

  * robust detection accuracy >= 90% of the suite at moderate intensity
    (1.0) in every provider cell;
  * the naive path degrades measurably at moderate intensity: mean
    accuracy at least `--min-naive-drop` benchmarks below its own calm
    (intensity 0) cell;
  * zero-intensity cells: naive == robust analysis would be vacuous
    (identical pairs), so instead the calm accuracy must stay at the
    committed level (baseline comparison).

``--check-baseline`` additionally fails if any cell's robust accuracy
fell more than 2 benchmarks below the committed file's value — the same
ratchet pattern as perf_bench / service_bench.

All metrics are virtual-time and seed-deterministic: runner speed never
changes a number.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def run(quick: bool, seed: int) -> dict:
    # this harness and the paper table are literally the same code
    import repro_torch.benchmarks.paper_tables as paper_tables
    if seed:
        paper_tables.set_base_seed(seed)
    name, us, rows = paper_tables.table_chaos_robustness(quick=quick)
    return {"name": name, "harness_us": us, "quick": quick,
            "seed": seed, "rows": rows}


def check(point: dict, *, min_naive_drop: float = 1.0) -> list:
    """Returns a list of failure strings (empty = all claims hold)."""
    rows = point["rows"]
    target = rows.get("target_robust_pct_min", 90.0)
    fails = []
    cells = {k: v for k, v in rows.items() if isinstance(v, dict)}
    providers = sorted({k.rsplit("_i", 1)[0] for k in cells})
    for prov in providers:
        calm = cells.get(f"{prov}_i0")
        mod = cells.get(f"{prov}_i1")
        if mod is None:
            fails.append(f"{prov}: no moderate-intensity cell")
            continue
        if mod["accuracy_robust_pct"] < target:
            fails.append(
                f"{prov}: robust accuracy {mod['accuracy_robust_pct']:.1f}%"
                f" < {target:.0f}% at moderate intensity")
        if calm is not None and (calm["accuracy_naive"]
                                 - mod["accuracy_naive"]) < min_naive_drop:
            fails.append(
                f"{prov}: naive path did not degrade under chaos "
                f"(calm {calm['accuracy_naive']:.1f} -> moderate "
                f"{mod['accuracy_naive']:.1f})")
        if mod["accuracy_robust"] < mod["accuracy_naive"]:
            fails.append(
                f"{prov}: robust path worse than naive at moderate "
                f"intensity ({mod['accuracy_robust']:.1f} < "
                f"{mod['accuracy_naive']:.1f})")
    return fails


def check_baseline(point: dict, baseline_path: str, *,
                   tolerance: float = 2.0) -> list:
    with open(baseline_path) as f:
        base = json.load(f)
    fails = []
    for key, cell in point["rows"].items():
        if not isinstance(cell, dict):
            continue
        ref = base.get("rows", {}).get(key)
        if not isinstance(ref, dict):
            continue
        if cell["accuracy_robust"] < ref["accuracy_robust"] - tolerance:
            fails.append(
                f"{key}: robust accuracy regressed "
                f"{ref['accuracy_robust']:.1f} -> "
                f"{cell['accuracy_robust']:.1f} (tolerance {tolerance})")
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="lambda only, intensities (0, 1), 2 seeds/cell")
    ap.add_argument("--out", default=None, help="write the JSON point here")
    ap.add_argument("--check", action="store_true",
                    help="fail unless the acceptance claims hold")
    ap.add_argument("--check-baseline", default=None,
                    help="committed BENCH_chaos.json to ratchet against")
    ap.add_argument("--min-naive-drop", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a virtual-time trace of the sweep "
                         "(chaos fault instants included) and write "
                         "Chrome trace_event JSON")
    ap.add_argument("--metrics-out", default=None, metavar="OUT.json",
                    help="write the metrics registry snapshot "
                         "(render with `python -m repro_torch.obs.report`)")
    args = ap.parse_args(argv)

    obs = None
    if args.trace or args.metrics_out:
        from repro_torch.obs import Observability, set_obs
        obs = Observability.recording()
        set_obs(obs)

    point = run(args.quick, args.seed)
    if obs is not None:
        if args.trace:
            obs.export_trace(args.trace)
            print(f"trace: {len(obs.tracer)} events -> {args.trace}")
        if args.metrics_out:
            obs.export_metrics(args.metrics_out)
            print(f"metrics -> {args.metrics_out}")
    print(json.dumps(point, indent=2, sort_keys=True))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(point, f, indent=2, sort_keys=True)

    fails = []
    if args.check or args.check_baseline:
        fails += check(point, min_naive_drop=args.min_naive_drop)
    if args.check_baseline and os.path.exists(args.check_baseline):
        fails += check_baseline(point, args.check_baseline)
    for f in fails:
        print(f"CHECK FAILED: {f}", file=sys.stderr)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
