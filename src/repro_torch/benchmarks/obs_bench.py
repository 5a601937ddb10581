"""SLO-detection harness: scores the live monitoring stack against
seeded chaos runs with *known* injected incidents, writes the
``slo_detection`` table (BENCH_obs.json), and gates CI on its claims.

    PYTHONPATH=src python -m repro_torch.benchmarks.obs_bench [--quick]
        [--out build/bench/BENCH_obs.json] [--check]
        [--check-baseline BENCH_obs.json] [--seed N]

The port's twin of the JAX package's ``benchmarks/obs_bench.py``, over
the port's ``obs.watch`` (host only; no card).

Each cell runs one incident scenario (repro_torch.obs.watch) at one fault
intensity under one detection system:

  * ``monitor`` — the full adaptive stack: SLO burn-rate evaluators +
    EWMA z-score / rate-spike / stuck-gauge banks;
  * ``naive``   — the comparison baseline: fixed static thresholds at
    ~2x the calm level, no SLOs (watch.naive_banks).

Scores come from watch.score_detection against the chaos layer's
injection log (exact fault timestamps — ground truth, not labels).

Checks (``--check``, implied by ``--check-baseline``):

  * monitor recall >= 0.9 over all injected incident windows;
  * every detected incident is caught within half its duration
    (virtual time-to-detect);
  * zero false alerts on the calm twin (monitor);
  * the naive baseline is present and strictly worse on recall at the
    subtle intensity (otherwise the adaptive machinery is dead weight).

All metrics are virtual-time and seed-deterministic: runner speed never
changes a number.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

SCENARIOS = ("timeout_storm", "region_degradation", "zombie_wave")
# 1.0 = the scenario as specified (blatant); 0.35 = subtle — sized so a
# fixed 2x-calm threshold sits above the perturbed level
INTENSITIES = ((1.0, "i100"), (0.35, "i35"))
SYSTEMS = (("monitor", False), ("naive", True))


def _cell(health: dict) -> dict:
    det = health["detection"]
    windows = det["windows"]
    ttd_ok = all(w["ttd_s"] <= w["duration_s"] / 2.0
                 for w in windows if w["detected"])
    return {
        "recall": det["recall"],
        "precision": det["precision"],
        "false_alerts": det["false_alerts"],
        "late_signals": det.get("late_signals", 0),
        "signals": det["signals"],
        "mean_ttd_s": det["mean_ttd_s"],
        "ttd_within_half": bool(windows) and ttd_ok,
        "incident_s": (round(sum(w["duration_s"] for w in windows), 1)
                       if windows else 0.0),
        "verdict": health["verdict"],
        "incidents": len(health["incidents"]),
    }


def run(quick: bool, seed: int) -> dict:
    from repro_torch.obs.watch import run_scenario
    t0 = time.perf_counter()
    rows: dict = {}
    for scen in SCENARIOS:
        for intensity, tag in INTENSITIES:
            for sysname, naive in SYSTEMS:
                h = run_scenario(scen, seed=seed, quick=quick,
                                 intensity=intensity, naive=naive)
                rows[f"{scen}_{tag}_{sysname}"] = _cell(h)
    for sysname, naive in SYSTEMS:
        h = run_scenario("calm", seed=seed, quick=quick, naive=naive)
        rows[f"calm_{sysname}"] = {
            "false_alerts": h["detection"]["signals"],
            "verdict": h["verdict"],
        }

    def _agg(sysname):
        cells = [v for k, v in rows.items()
                 if k.endswith(f"_{sysname}") and "recall" in v]
        n = max(1, len(cells))
        return {
            "recall_mean": round(sum(c["recall"] for c in cells) / n, 4),
            "recall_min": min((c["recall"] for c in cells), default=0.0),
            "false_alerts": sum(c["false_alerts"] for c in cells),
            "ttd_within_half_all": all(c["ttd_within_half"]
                                       for c in cells),
        }

    rows["monitor_summary"] = _agg("monitor")
    rows["naive_summary"] = _agg("naive")
    subtle = [k for k in rows if "_i35_" in k]
    rows["subtle_recall_monitor"] = round(
        sum(rows[k]["recall"] for k in subtle if k.endswith("_monitor"))
        / max(1, len(SCENARIOS)), 4)
    rows["subtle_recall_naive"] = round(
        sum(rows[k]["recall"] for k in subtle if k.endswith("_naive"))
        / max(1, len(SCENARIOS)), 4)
    harness_us = (time.perf_counter() - t0) * 1e6
    return {"name": "slo_detection", "harness_us": harness_us,
            "quick": quick, "seed": seed, "rows": rows}


def check(point: dict) -> list:
    """Returns a list of failure strings (empty = all claims hold)."""
    rows = point["rows"]
    fails = []
    mon = rows["monitor_summary"]
    if mon["recall_mean"] < 0.9:
        fails.append(f"monitor recall {mon['recall_mean']:.2f} < 0.9")
    if not mon["ttd_within_half_all"]:
        slow = [k for k, v in rows.items()
                if k.endswith("_monitor") and isinstance(v, dict)
                and "ttd_within_half" in v and not v["ttd_within_half"]]
        fails.append(f"time-to-detect exceeded half the incident "
                     f"duration in: {slow}")
    if mon["false_alerts"]:
        fails.append(f"monitor fired {mon['false_alerts']} pre-incident "
                     f"false alerts in incident runs")
    if rows["calm_monitor"]["false_alerts"]:
        fails.append(f"monitor fired "
                     f"{rows['calm_monitor']['false_alerts']} alerts on "
                     f"the calm twin")
    if rows["calm_monitor"]["verdict"] != "healthy":
        fails.append(f"calm twin verdict "
                     f"{rows['calm_monitor']['verdict']!r} != healthy")
    if "naive_summary" not in rows:
        fails.append("naive baseline missing from the table")
    elif rows["subtle_recall_naive"] >= rows["subtle_recall_monitor"]:
        fails.append(
            f"naive baseline matches the monitor at subtle intensity "
            f"({rows['subtle_recall_naive']:.2f} >= "
            f"{rows['subtle_recall_monitor']:.2f}) — the adaptive "
            f"machinery is dead weight")
    return fails


def check_baseline(point: dict, baseline_path: str) -> list:
    """Ratchet: recall must not fall below the committed table."""
    with open(baseline_path) as f:
        base = json.load(f)
    fails = []
    for key in ("monitor_summary",):
        cur = point["rows"][key]["recall_mean"]
        ref = base["rows"][key]["recall_mean"]
        if cur < ref - 1e-9:
            fails.append(f"{key} recall regressed: {cur:.4f} < committed "
                         f"{ref:.4f}")
    cal = point["rows"]["calm_monitor"]["false_alerts"]
    if cal > base["rows"]["calm_monitor"]["false_alerts"]:
        fails.append(f"calm false alerts grew to {cal}")
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, metavar="OUT.json")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--check-baseline", default=None, metavar="BENCH.json")
    args = ap.parse_args(argv)

    point = run(args.quick, args.seed)
    print(f"slo_detection,{point['harness_us']:.0f},"
          f"{json.dumps(point['rows'], sort_keys=True)}")
    print()
    for k in sorted(point["rows"]):
        print(f"    {k:40s} {point['rows'][k]}")

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(point, f, indent=1, sort_keys=True)
        print(f"\n-> {args.out}")

    fails = []
    if args.check or args.check_baseline:
        fails = check(point)
    if args.check_baseline:
        fails += check_baseline(point, args.check_baseline)
    for fmsg in fails:
        print(f"CHECK FAIL: {fmsg}", file=sys.stderr)
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
