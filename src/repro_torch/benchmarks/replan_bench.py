"""Online re-planning benchmark — the `replan_vs_static` table.

Runs the same multi-round, multi-tenant service scenario twice per chaos
level — once with the static scheduler (no controller) and once with the
`ReplanController` armed — and records what closing the control loop
buys under live drift:

  * deadline hit-rate against the ORIGINAL deadlines (renegotiated terms
    are reported separately; the table judges the promise the tenant
    actually made, with preempt-resume continuations credited back to
    their original job)
  * completed / preempted / deferred / resumed job counts
  * total billed cost (USD, virtual billing)
  * detection quality (recall / precision / mean TTD) of the monitoring
    plane against the chaos backend's injected ground truth — a pinned
    canary job rides the chaotic provider every round in BOTH arms, so
    re-planning must not degrade what the detectors can see
  * the zero-chaos identity row: with the controller armed but nothing
    firing, every round's schedule digest must equal the static arm's
    bit-for-bit (the controller's hard determinism invariant)

All quantities are virtual-time and therefore pure functions of the
seed.  ``--check-baseline`` gates: the zero-chaos digests must match the
committed baseline exactly, and under moderate/heavy chaos the replan
arm must hold a deadline hit-rate >= the static arm while detection
recall stays within +/-2 points of static.

The port's twin of the JAX package's ``benchmarks/replan_bench.py``,
over the port's copies of the service, chaos and obs layers (host only;
no card).  Its document goes to ``build/bench/`` unless ``--out`` says
otherwise: the ``BENCH_replan.json`` at the checkout's root is the JAX
package's committed baseline, which ``--check-baseline`` reads.

Usage:
    PYTHONPATH=src python -m repro_torch.benchmarks.replan_bench [--quick]
        [--out build/bench/BENCH_replan.json]
        [--check-baseline BENCH_replan.json] [--incidents-out DIR]
"""
from __future__ import annotations

import argparse
import json
import platform
import sys
import time

from repro_torch.core.experiment import victoriametrics_like_suite
from repro_torch.faas.chaos import TIMEOUT_STORM, ChaosConfig, FaultSpec
from repro_torch.obs import Observability, get_obs, set_obs
from repro_torch.obs.watch import score_detection
from repro_torch.service import (BenchmarkService, DeadlineCostPlanner, Job,
                                 PlannerConfig, ReplanConfig, ReplanController,
                                 ServiceConfig)

HIT_RATE_TOLERANCE = 0.0        # replan must not lose a single deadline
DETECTION_TOLERANCE = 0.02      # +/-2 points of recall vs the static arm

# the signal families detection is scored over: the provider-scoped
# drift signals the controller's trigger taxonomy acts on.  Workload-
# inherent SLOs (p99 latency of a suite whose benchmarks legitimately
# run tens of seconds, per-job budget burn) are recorded but are not
# chaos detectors, so they stay out of the precision/recall accounting.
DETECTION_KINDS = {"timeout_rate", "error_rate", "cold_start_rate"}
DETECTION_SERIES = {"engine.win.timeout", "engine.win.err",
                    "engine.win.latency", "engine.win.cold"}


def chaos_level(level: str, seed: int):
    """Lambda-scoped drift scenarios.  `moderate` is a phased storm the
    run enters mid-flight; `heavy` is a wall-to-wall timeout storm."""
    if level == "zero":
        return None
    if level == "moderate":
        return ChaosConfig(intensity=1.0, seed=seed, faults=(
            FaultSpec(TIMEOUT_STORM, rate=0.6, period_s=3600.0,
                      window_s=900.0, phase_s=60.0),
        ))
    if level == "heavy":
        return ChaosConfig(intensity=1.0, seed=seed, faults=(
            FaultSpec(TIMEOUT_STORM, rate=0.9, period_s=10_000_000.0,
                      window_s=4000.0, phase_s=0.0),
        ))
    raise ValueError(level)


def bench_suite(n=6):
    full = victoriametrics_like_suite()
    return {k: v for k, v in sorted(full.items())[:2 * n]
            if not v.fs_write and v.base_seconds < 10.0}


def build_service(chaos, armed: bool, seed: int):
    set_obs(Observability.monitoring())
    planner = DeadlineCostPlanner(PlannerConfig(
        providers=("lambda", "gcf"), memory_mb=(2048,),
        parallelism=(8, 16), repeat_plans=((5, 2),), autotune=False,
        include_vm=False))
    svc = BenchmarkService(
        ServiceConfig(parallelism=8, seed=seed, engine="fast",
                      chaos=({"lambda": chaos} if chaos else None)),
        planner=planner)
    ctrl = (svc.attach_controller(ReplanController(ReplanConfig()))
            if armed else None)
    return svc, ctrl


def run_arm(chaos, armed: bool, *, seed: int, rounds: int, tenants: int,
            canary_calls: int, deadline_s: float, tight_budget: float,
            include_tight: bool = True):
    """One arm of one scenario.  Returns (stats, digests)."""
    wl = bench_suite()
    svc, ctrl = build_service(chaos, armed, seed)
    originals = {}          # job_id -> (deadline_s, budget_usd)
    digests = []
    reports = []
    for rnd in range(rounds):
        svc.submit(Job(job_id=f"canary-{rnd}", tenant="canary",
                       workloads=wl, n_calls=canary_calls,
                       repeats_per_call=2, seed=100 + rnd,
                       metadata={"pin": True}), provider="lambda")
        for t in range(tenants):
            jid = f"job-{rnd}-{t}"
            svc.submit(Job(job_id=jid, tenant=f"t{t}", workloads=wl,
                           n_calls=5, repeats_per_call=2,
                           seed=200 + rnd * 10 + t,
                           deadline_s=deadline_s, budget_usd=2.0))
            originals[jid] = (deadline_s, 2.0)
        if rnd == 0 and include_tight:
            svc.submit(Job(job_id="tight", tenant="t0", workloads=wl,
                           n_calls=5, repeats_per_call=2, seed=7,
                           deadline_s=deadline_s,
                           budget_usd=tight_budget))
            originals["tight"] = (deadline_s, tight_budget)
        rep = svc.run()
        digests.append(rep.digest())
        reports.append(rep)
    # drain continuations / released deferrals left behind by the
    # controller's final round
    for _ in range(2):
        rep = svc.run()
        if not rep.results:
            break
        reports.append(rep)

    results = {}
    for rep in reports:
        for r in rep.results:
            results[r.job_id] = r
    hits = misses = 0
    total_cost = 0.0
    renegotiated = []
    for jid, (dl, _budget) in sorted(originals.items()):
        r = results.get(jid)
        if r is None:
            misses += 1             # still deferred: the promise slipped
            continue
        total_cost += r.cost_dollars
        cont = results.get(f"{jid}~r")
        if cont is not None:
            total_cost += cont.cost_dollars
        final = r
        if r.status != "completed":
            if cont is None or cont.status != "completed":
                misses += 1
                continue
            final = cont
        enqueue = r.end_s - r.latency_s
        ok = (final.end_s - enqueue) <= dl
        hits += ok
        misses += not ok
        if final.job_id.endswith("~r") or (r.job_id != final.job_id):
            renegotiated.append(jid)
    obs = get_obs()
    mon = obs.monitor
    truth = []
    for key in sorted(svc._fleets):
        fleet = svc._fleets[key]
        if fleet.provider == "lambda" and fleet.chaos_backend is not None:
            truth = fleet.chaos_backend.ground_truth()
            break
    det = score_detection(
        truth,
        [a for a in mon.alerts if a.get("kind") in DETECTION_KINDS],
        [a for a in mon.anomalies
         if a.get("series") in DETECTION_SERIES],
        window_s=mon.window_s)
    stats = {
        "jobs": len(originals),
        "deadline_hits": hits,
        "deadline_misses": misses,
        "deadline_hit_rate": round(hits / max(1, len(originals)), 4),
        "preempted": sum(1 for r in results.values()
                         if r.status == "preempted"),
        "resumed": sum(1 for j in results if j.endswith("~r")),
        "cost_usd": round(total_cost, 6),
        "detection": {
            "truth_windows": len(truth),
            "recall": det["recall"],
            "precision": det["precision"],
            "mean_ttd_s": det["mean_ttd_s"],
            "false_alerts": det["false_alerts"],
        },
    }
    if ctrl is not None:
        s = ctrl.summary()
        stats["controller"] = {
            "events_by_type": s["by_type"],
            "held_jobs": s["held_jobs"],
            "resumed_jobs": s["resumed_jobs"],
        }
        stats["deferred"] = s["by_type"].get("defer", 0)
        stats["renegotiations"] = s["by_type"].get(
            "deadline_renegotiated", 0)
    return stats, digests, (ctrl.events if ctrl else []), \
        (ctrl.open_incidents() if ctrl else [])


def run_replan_experiment(*, seed: int = 11, quick: bool = False) -> dict:
    """The committed table: zero / moderate / heavy chaos, each run
    static-vs-armed on identical job streams."""
    knobs = dict(rounds=2 if quick else 3, tenants=2 if quick else 3,
                 canary_calls=12 if quick else 25, deadline_s=700.0,
                 tight_budget=0.016, seed=seed)
    rows = []
    artifacts = {"incidents": [], "renegotiations": []}
    for level in ("zero", "moderate", "heavy"):
        t0 = time.perf_counter()
        chaos = chaos_level(level, seed)
        # the zero row is the calm-SLO twin: no budget-burner, so a
        # single fired signal of any kind is a contract violation
        tight = level != "zero"
        static, d_static, _, _ = run_arm(chaos, False,
                                         include_tight=tight, **knobs)
        replan, d_replan, events, incidents = run_arm(
            chaos, True, include_tight=tight, **knobs)
        row = {
            "scenario": level,
            "static": static,
            "replan": replan,
            "hit_rate_delta": round(replan["deadline_hit_rate"]
                                    - static["deadline_hit_rate"], 4),
            "detection_recall_delta": round(
                replan["detection"]["recall"]
                - static["detection"]["recall"], 4),
            "cost_delta_usd": round(replan["cost_usd"]
                                    - static["cost_usd"], 6),
            "harness_s": round(time.perf_counter() - t0, 2),
        }
        if level == "zero":
            row["digests_static"] = d_static
            row["digests_replan"] = d_replan
            row["identical"] = d_static == d_replan
            row["controller_idle"] = not events
        else:
            artifacts["incidents"].extend(
                {"scenario": level, **inc} for inc in incidents)
            artifacts["renegotiations"].extend(
                {"scenario": level, **ev} for ev in events
                if ev["event"] == "deadline_renegotiated")
        rows.append(row)
    return {
        "schema": 1,
        "scenario": "replan_vs_static",
        "seed": seed,
        "quick": quick,
        "python": platform.python_version(),
        "knobs": knobs,
        "replan_vs_static": rows,
        "artifacts": artifacts,
    }


def check_baseline(doc: dict, baseline_path: str) -> int:
    failures = []
    try:
        with open(baseline_path) as f:
            base_rows = {r["scenario"]: r
                         for r in json.load(f)["replan_vs_static"]}
    except (OSError, ValueError, KeyError) as e:
        print(f"cannot read baseline {baseline_path}: {e}",
              file=sys.stderr)
        return 1
    for row in doc["replan_vs_static"]:
        name = row["scenario"]
        base = base_rows.get(name)
        if name == "zero":
            if not row["identical"]:
                failures.append("zero: armed digests != static digests "
                                "(determinism contract broken)")
            if not row["controller_idle"]:
                failures.append("zero: controller acted with no trigger")
            fa = row["replan"]["detection"]["false_alerts"]
            if fa:
                failures.append(
                    f"zero: calm run fired {fa} spurious signals")
            if base is not None and base.get("digests_static") \
                    and not doc["quick"] \
                    and row["digests_static"] != base["digests_static"]:
                failures.append(
                    f"zero: schedule digests {row['digests_static']} != "
                    f"committed baseline {base['digests_static']}")
            continue
        s, r = row["static"], row["replan"]
        if r["deadline_hit_rate"] + HIT_RATE_TOLERANCE \
                < s["deadline_hit_rate"]:
            failures.append(
                f"{name}: replan hit-rate {r['deadline_hit_rate']} < "
                f"static {s['deadline_hit_rate']}")
        if abs(row["detection_recall_delta"]) > DETECTION_TOLERANCE:
            failures.append(
                f"{name}: detection recall moved "
                f"{row['detection_recall_delta']:+} "
                f"(tolerance {DETECTION_TOLERANCE})")
        if not r.get("controller", {}).get("events_by_type"):
            failures.append(f"{name}: controller recorded no events "
                            f"under chaos (loop not closed)")
    if failures:
        print("replan gate FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(f"replan gate OK ({len(doc['replan_vs_static'])} scenarios, "
          f"recall tolerance {DETECTION_TOLERANCE})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized run (fewer rounds/tenants); relational "
                         "gates only, no digest pin")
    ap.add_argument("--out", default="build/bench/BENCH_replan.json")
    ap.add_argument("--check-baseline", default=None, metavar="FILE")
    ap.add_argument("--incidents-out", default=None, metavar="DIR",
                    help="write incident + renegotiation artifacts as "
                         "standalone JSON files")
    args = ap.parse_args(argv)

    doc = run_replan_experiment(seed=args.seed, quick=args.quick)
    if args.out:
        import os
        d = os.path.dirname(args.out)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}")
    if args.incidents_out:
        import os
        os.makedirs(args.incidents_out, exist_ok=True)
        for name in ("incidents", "renegotiations"):
            path = os.path.join(args.incidents_out, f"{name}.json")
            with open(path, "w") as f:
                json.dump(doc["artifacts"][name], f, indent=1,
                          sort_keys=True)
                f.write("\n")
            print(f"wrote {path}")
    print(json.dumps(
        [{k: v for k, v in row.items() if k != "harness_s"}
         for row in doc["replan_vs_static"]], indent=1, sort_keys=True))
    if args.check_baseline:
        return check_baseline(doc, args.check_baseline)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
