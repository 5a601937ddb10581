"""Health-verdict CLI: run a seeded scenario under live SLO monitoring
and emit a machine-readable verdict (CI gate).

    PYTHONPATH=src python -m repro_torch.obs.watch --scenario timeout_storm \
        [--seed N] [--quick] [--out health.json] [--incidents-out inc.json]
        [--expect-incident] [--expect-clean] [--slo SLOS.json]

Scenarios (all virtual-time, bit-reproducible per seed):

  calm                 no chaos — the null hypothesis.  Gate: zero
                       alerts, zero anomalies, verdict ``healthy``.
  timeout_storm        a timeout storm opens at t=900 for 240 s
                       (rate 0.95): the timeout-rate / error-rate burn
                       SLOs and the err/timeout rate-spike detectors
                       must catch it.
  region_degradation   a deterministic StepTrace slows the platform 4x
                       over [900, 1500): the latency EWMA z-score
                       detector must catch the shift.
  zombie_wave          zombies are armed in [900, 1200): the corpses
                       poison the warm pool and the resulting
                       instance-dead failures must trip the error-rate
                       SLO / rate-spike detector.

The injected incident window is *known* (chaos ground truth), so the
verdict includes a ``detection`` block scoring recall, precision, and
virtual time-to-detect against it — the same scorer
benchmarks/obs_bench.py uses for the committed ``slo_detection`` table.

Exit codes: 0 ok; 1 the gate failed (--expect-incident: the injected
incident was missed / --expect-clean: a false alert fired / neither:
an SLO breached).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Tuple

SCENARIOS = ("calm", "timeout_storm", "region_degradation", "zombie_wave")

# incident placement shared by every non-calm scenario: 900 s of calm
# baseline (detector warmup), then the fault window
_T0 = 900.0
_NEVER = 10_000_000.0        # period >> run wall: exactly one window


def build_scenario(name: str, seed: int) -> Tuple[object, List[dict]]:
    """Returns (ChaosConfig | None, ground-truth incident windows).

    Fault scenarios derive truth from the chaos backend's injection log
    after the run (exact hit times); trace scenarios know their window
    statically — ``t1 <= 0`` marks rows to fill in from the backend."""
    from repro_torch.faas.chaos import (TIMEOUT_STORM, ZOMBIE, ChaosConfig,
                                  FaultSpec)
    from repro_torch.faas.traces import StepTrace
    if name == "calm":
        return None, []
    if name == "timeout_storm":
        cfg = ChaosConfig(intensity=1.0, seed=seed, faults=(
            FaultSpec(TIMEOUT_STORM, rate=0.95, period_s=_NEVER,
                      window_s=240.0, phase_s=_T0),))
        return cfg, [{"kind": "storm_timeouts", "t0": _T0, "t1": -1.0}]
    if name == "region_degradation":
        cfg = ChaosConfig(intensity=1.0, seed=seed, traces=(
            StepTrace(factor=4.0, t0_s=_T0, t1_s=_T0 + 600.0),))
        return cfg, [{"kind": "step_degradation", "t0": _T0,
                      "t1": _T0 + 600.0}]
    if name == "zombie_wave":
        cfg = ChaosConfig(intensity=1.0, seed=seed, faults=(
            FaultSpec(ZOMBIE, rate=0.9, period_s=_NEVER,
                      window_s=300.0, phase_s=_T0),))
        return cfg, [{"kind": "zombie_hits", "t0": _T0, "t1": -1.0}]
    raise ValueError(f"unknown scenario {name!r} (one of {SCENARIOS})")


def naive_banks(metrics, provider, feed, window_s):
    """The comparison baseline: fixed absolute thresholds an operator
    might set at ~2x the calm level — no adaptive baseline, no burn-rate
    windows.  Catches blatant incidents, misses subtle ones (and that
    gap is exactly what benchmarks/obs_bench.py measures)."""
    from repro_torch.obs.detectors import DetectorBank, StaticThreshold
    labels = {"provider": provider}
    return [
        DetectorBank("engine.win.latency", feed.lat,
                     [StaticThreshold(value="mean", threshold=20.0)],
                     labels),
        DetectorBank("engine.win.err", feed.err,
                     [StaticThreshold(value="sum", threshold=10.0)],
                     labels),
        DetectorBank("engine.win.timeout", feed.timeout,
                     [StaticThreshold(value="sum", threshold=10.0)],
                     labels),
    ]


def run_scenario(name: str, *, seed: int = 0, quick: bool = False,
                 slos=None, intensity: float = 1.0,
                 naive: bool = False) -> dict:
    """Run one scenario with monitoring armed; returns the health dict
    extended with scenario metadata, ground truth, and detection scores.

    ``intensity`` scales the injected fault (1.0 = as specified; lower
    is subtler).  ``naive=True`` swaps the whole adaptive stack for the
    static-threshold baseline (no SLO evaluators, naive_banks only).

    Installs (and restores) the process-global obs context."""
    from repro_torch.core import rmit
    from repro_torch.faas.backends import SimFaaSBackend
    from repro_torch.faas.chaos import ChaosBackend
    from repro_torch.faas.engine import EngineConfig, ExecutionEngine
    from repro_torch.faas.platform import SimWorkload
    from repro_torch.obs import Observability, use_obs

    chaos_cfg, truth = build_scenario(name, seed)
    if chaos_cfg is not None and intensity != 1.0:
        chaos_cfg = chaos_cfg.scaled(intensity)
    suite = {f"bench{i}": SimWorkload(name=f"bench{i}",
                                      base_seconds=1.0 + 0.5 * i,
                                      effect_pct=0.0,
                                      setup_seconds=2.0)
             for i in range(4)}
    # quick still has to reach past the incident window ([900, ~1500) of
    # virtual time) with room for the post-incident clear
    n_calls = 110 if quick else 150
    plan = rmit.make_plan(sorted(suite), n_calls=n_calls,
                          repeats_per_call=2, seed=seed)
    backend = SimFaaSBackend(suite, seed=seed)
    if chaos_cfg is not None:
        backend = ChaosBackend(backend, chaos_cfg)
    if naive:
        from repro_torch.obs import (FlightRecorder, MetricsRegistry,
                               RecordingTracer, SLOMonitor)
        rec = FlightRecorder(capacity=2048, max_dumps=8)
        metrics = MetricsRegistry()
        mon = SLOMonitor([], metrics=metrics, bank_factory=naive_banks)
        obs = Observability(RecordingTracer(recorder=rec), metrics, rec,
                            mon)
    else:
        obs = Observability.monitoring(slos)
    with use_obs(obs):
        rep = ExecutionEngine(backend, EngineConfig(parallelism=2)).run(plan)
        health = obs.health()
    # fault scenarios: replace the static placeholder with the backend's
    # injection log (exact first/last hit of the armed window)
    if truth and any(tw["t1"] <= 0 for tw in truth):
        injected = {r["kind"]: r for r in backend.ground_truth()}
        resolved = []
        for tw in truth:
            if tw["t1"] > 0:
                resolved.append(tw)
                continue
            hit = injected.get(tw["kind"])
            if hit is not None:
                resolved.append(hit)
        truth = resolved
    mon = obs.monitor
    health["scenario"] = {"name": name, "seed": seed, "quick": quick,
                          "intensity": intensity, "naive": naive,
                          "wall_s": round(rep.wall_seconds, 3),
                          "invocations": rep.invocations_done,
                          "errors": rep.failures,
                          "timeouts": rep.timeouts}
    health["ground_truth"] = truth
    health["detection"] = score_detection(
        truth, health["alerts"], health["anomalies"],
        window_s=mon.window_s if mon is not None else 60.0)
    return health


def score_detection(truth: List[dict], alerts: List[dict],
                    anomalies: List[dict], *, window_s: float = 60.0,
                    slack_s: Optional[float] = None) -> dict:
    """Score fired signals against known injected-incident windows.

    A signal's effective time is the close of the window it fired on
    (``t_end`` when present — windowed detectors can only speak at a
    window close — else ``t``).  A truth window counts as detected when
    any fire/breach signal lands inside [t0, t1 + slack]; ``ttd_s`` is
    virtual time from incident onset to the earliest matching signal.

    Strays split by causality: a signal *before every* incident onset
    is a **false alert** (the spurious case the calm twin guards); a
    signal after an onset but outside every window is a **late signal**
    (trailing consequence — e.g. a cumulative-distribution SLO that
    stays breached after the fault clears) and is reported separately,
    not counted as false."""
    slack = 2.0 * window_s if slack_s is None else slack_s

    def eff(s):
        t_end = s.get("t_end")
        return float(t_end if t_end is not None else s.get("t", 0.0))

    sig = sorted((s for s in list(alerts) + list(anomalies)
                  if s.get("state") in ("fire", "breach")),
                 key=lambda s: (eff(s), s.get("slo",
                                              s.get("detector", ""))))
    windows = []
    matched = set()
    n_det = 0
    for tw in truth:
        t0, t1 = float(tw["t0"]), float(tw["t1"])
        hits = [i for i, s in enumerate(sig)
                if t0 <= eff(s) <= t1 + slack]
        detected = bool(hits)
        n_det += detected
        matched.update(hits)
        windows.append({
            "kind": tw["kind"], "t0": t0, "t1": t1,
            "duration_s": round(t1 - t0, 3),
            "detected": detected,
            "ttd_s": (round(eff(sig[hits[0]]) - t0, 3)
                      if detected else None),
            "signals": len(hits)})
    onset = min((float(tw["t0"]) for tw in truth), default=None)
    false_alerts = late = 0
    for i, s in enumerate(sig):
        if i in matched:
            continue
        if onset is not None and eff(s) >= onset:
            late += 1
        else:
            false_alerts += 1
    return {
        "windows": windows,
        "signals": len(sig),
        "false_alerts": false_alerts,
        "late_signals": late,
        "recall": round(n_det / len(truth), 4) if truth else 1.0,
        "precision": (round(len(matched) / len(sig), 4) if sig else 1.0),
        "mean_ttd_s": (round(sum(w["ttd_s"] for w in windows
                               if w["ttd_s"] is not None)
                             / max(1, n_det), 3) if n_det else None),
    }


def _gate(health: dict, *, expect_incident: bool,
          expect_clean: bool) -> List[str]:
    """Returns failure strings (empty = the gate passes)."""
    det = health["detection"]
    fails = []
    if expect_clean:
        if det["signals"]:
            fails.append(f"expected a clean run but {det['signals']} "
                         f"signals fired")
        if health["verdict"] != "healthy":
            fails.append(f"expected verdict healthy, got "
                         f"{health['verdict']!r}")
    if expect_incident:
        if not health["ground_truth"]:
            fails.append("scenario injected no incident to detect")
        if det["recall"] < 1.0:
            missed = [w["kind"] for w in det["windows"]
                      if not w["detected"]]
            fails.append(f"missed injected incident(s): {missed}")
        if det["false_alerts"]:
            fails.append(f"{det['false_alerts']} signals fired before "
                         f"the injected incident")
        for w in det["windows"]:
            if w["detected"] and w["ttd_s"] > max(w["duration_s"] / 2.0,
                                                  60.0):
                fails.append(
                    f"{w['kind']}: time-to-detect {w['ttd_s']:.0f}s "
                    f"> half the incident duration "
                    f"({w['duration_s'] / 2.0:.0f}s)")
    if not expect_incident and not expect_clean \
            and health["verdict"] == "breach":
        fails.append("SLO breach")
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="calm", choices=SCENARIOS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="shorter workload (CI smoke)")
    ap.add_argument("--slo", default=None, metavar="SLOS.json",
                    help="SLO spec file (default: stock objectives)")
    ap.add_argument("--out", default=None, metavar="OUT.json",
                    help="write the full health verdict JSON")
    ap.add_argument("--incidents-out", default=None, metavar="OUT.json",
                    help="write just the incident log JSON")
    ap.add_argument("--expect-incident", action="store_true",
                    help="gate: fail unless every injected incident is "
                         "detected in time with zero stray signals")
    ap.add_argument("--expect-clean", action="store_true",
                    help="gate: fail if anything fires at all")
    args = ap.parse_args(argv)

    slos = None
    if args.slo:
        from repro_torch.obs.slo import load_slos
        slos = load_slos(args.slo)
    health = run_scenario(args.scenario, seed=args.seed, quick=args.quick,
                          slos=slos)

    det = health["detection"]
    sc = health["scenario"]
    print(f"scenario {sc['name']} seed={sc['seed']}: "
          f"wall {sc['wall_s']:.0f}s, {sc['invocations']} invocations, "
          f"{sc['errors']} errors, {sc['timeouts']} timeouts")
    print(f"verdict: {health['verdict']}  "
          f"({len(health['alerts'])} alerts, "
          f"{len(health['anomalies'])} anomalies, "
          f"{len(health['incidents'])} incidents)")
    for w in det["windows"]:
        state = (f"detected in {w['ttd_s']:.0f}s" if w["detected"]
                 else "MISSED")
        print(f"  injected {w['kind']} [{w['t0']:.0f}, {w['t1']:.0f}]: "
              f"{state} ({w['signals']} signals)")
    if det["false_alerts"]:
        print(f"  false alerts: {det['false_alerts']}")
    for inc in health["incidents"]:
        print(f"  incident {inc['id']} "
              f"[{inc['t_start']:.0f}, {inc['t_end']:.0f}] "
              f"{inc['severity']}: {inc['root_cause']}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(health, f, indent=1, sort_keys=True)
        print(f"health -> {args.out}")
    if args.incidents_out:
        with open(args.incidents_out, "w") as f:
            json.dump({"schema": 1, "incidents": health["incidents"]},
                      f, indent=1, sort_keys=True)
        print(f"incidents -> {args.incidents_out}")

    fails = _gate(health, expect_incident=args.expect_incident,
                  expect_clean=args.expect_clean)
    for fmsg in fails:
        print(f"GATE FAIL: {fmsg}", file=sys.stderr)
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
