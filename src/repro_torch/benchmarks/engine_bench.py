"""Engine-core scaling benchmark — scalar reference vs vectorized engine.

Replays one synthetic 1,000-benchmark tenant (clean workloads: no
restricted-FS lanes, no always-timeout lane, no unstable lanes — the
steady-state fast path a planet-scale deployment lives on; per-trial
durations in the few-hundred-ms band typical of microbenchmark batches,
which keeps scheduling waves dense) at plan sizes
N = 10^3 .. 10^6 invocations on the Lambda profile with parallelism
4,000 — the elastic-concurrency regime the paper's architecture exists
for — and times both engines.  At every size where the scalar engine is
run, the two EngineReports are compared **bit-for-bit** (pairs, billed
seconds, cost, every counter) — the speedup numbers are only meaningful
because the answers are identical.

Wall-clock µs/invocation depends on the runner, so the regression gate
compares *ratios*: the vectorized speedup (scalar µs / vectorized µs)
must not fall below half the committed baseline's speedup at any common
size, and the vectorized engine's own µs/invocation must not exceed 2x
baseline.  ``--check-baseline`` exits non-zero on either.

``--trace-overhead`` instead measures the observability tax on the
vectorized engine: the same plan is replayed with no observability
context, with the ``NullTracer`` (tracing compiled in but disabled — the
default for every production run), with a full ``RecordingTracer``, and
with live SLO monitoring armed (recording plus windowed feeds, detector
banks, and SLO evaluators).  All four runs must produce bit-identical
digests; the null/off ratio is gated at 1.05 — the "instrumentation is
free when off" contract — and monitoring/off at 1.10 — watching the
stream costs at most a dime on the dollar.  Ratios are measured inside
one process so the gate is runner-independent; the rows land under an
``obs_overhead`` key merged into the baseline JSON without touching the
``sizes`` rows.

The port's twin of the JAX package's ``benchmarks/engine_bench.py``,
over the port's copies of the engines (host only; no card).

Usage:
    PYTHONPATH=src python -m repro_torch.benchmarks.engine_bench
        [--quick] [--out build/bench/BENCH_engine.json]
        [--check-baseline BENCH_engine.json]
        [--trace-overhead]
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

N_BENCH = 1000
PARALLELISM = 4000
REPEATS = 3
SIZES_FULL = (1_000, 10_000, 100_000, 1_000_000)
SIZES_QUICK = (1_000, 10_000)
SCALAR_CAP_QUICK = 10_000       # scalar reference sizes in --quick mode
GATE_FACTOR = 2.0


def synthetic_suite(n: int = N_BENCH, seed: int = 0):
    import numpy as np
    from repro_torch.faas.platform import SimWorkload

    rng = np.random.default_rng(seed)
    suite = {}
    for i in range(n):
        name = f"Bench{i:04d}"
        suite[name] = SimWorkload(
            name=name,
            base_seconds=float(rng.uniform(0.2, 0.5)),
            effect_pct=float(rng.normal(0.0, 5.0)),
            run_sigma=float(rng.uniform(0.02, 0.05)),
            setup_seconds=float(rng.uniform(2.0, 8.0)),
        )
    return suite


def make_size_plan(suite, n_invocations: int, seed: int = 0):
    from repro_torch.core.rmit import make_plan
    n_calls = max(1, n_invocations // len(suite))
    return make_plan(sorted(suite), n_calls=n_calls,
                     repeats_per_call=REPEATS, seed=seed)


def _digest(report) -> str:
    import hashlib
    h = hashlib.sha256()
    for p in report.pairs:
        h.update(f"{p.benchmark},{p.v1_seconds!r},{p.v2_seconds!r},"
                 f"{p.cold_start}\n".encode())
    h.update(f"{report.cost_dollars!r},{report.wall_seconds!r},"
             f"{report.cold_starts},{report.timeouts},{report.failures},"
             f"{report.invocations_done}\n".encode())
    for b in report.billed_seconds:
        h.update(f"{b!r}\n".encode())
    return h.hexdigest()[:16]


def _run(engine_kind: str, suite, plan, seed: int, reps: int = 1):
    """Run ``reps`` times on fresh identically-seeded backends and keep
    the best wall time (noise is strictly additive; every rep is
    deterministic, so the reports are interchangeable).  GC is paused
    during the timed region — with 10^6 live invocation objects a single
    gen-2 collection costs more than the run under test."""
    import gc

    from repro_torch.faas.backends import SimFaaSBackend
    from repro_torch.faas.engine import EngineConfig
    from repro_torch.faas.engine_vec import make_engine

    best_s, report = float("inf"), None
    gc_was = gc.isenabled()
    gc.disable()
    try:
        for _ in range(reps):
            backend = SimFaaSBackend(suite, seed=seed)
            eng = make_engine(backend, EngineConfig(parallelism=PARALLELISM),
                              engine=engine_kind)
            t0 = time.perf_counter()
            report = eng.run(plan)
            best_s = min(best_s, time.perf_counter() - t0)
    finally:
        if gc_was:
            gc.enable()
        gc.collect()
    return report, best_s


def run_profile(quick: bool, seed: int) -> list:
    suite = synthetic_suite(seed=seed)
    sizes = SIZES_QUICK if quick else SIZES_FULL
    scalar_cap = SCALAR_CAP_QUICK if quick else max(SIZES_FULL)
    rows = []
    for n in sizes:
        plan = make_size_plan(suite, n, seed=seed)
        n_inv = len(plan.invocations)
        fast_rep, fast_s = _run("fast", suite, plan, seed,
                                reps=3 if n <= 100_000 else 2)
        row = {
            "n_invocations": n_inv,
            "vec_s": round(fast_s, 4),
            "vec_us_per_inv": round(fast_s / n_inv * 1e6, 3),
            "digest": _digest(fast_rep),
        }
        if n <= scalar_cap:
            ref_rep, ref_s = _run("reference", suite, plan, seed,
                                  reps=2 if n <= 100_000 else 1)
            ref_digest = _digest(ref_rep)
            if ref_digest != row["digest"]:
                raise AssertionError(
                    f"conformance FAILED at N={n_inv}: vectorized digest "
                    f"{row['digest']} != scalar {ref_digest}")
            row["scalar_s"] = round(ref_s, 4)
            row["scalar_us_per_inv"] = round(ref_s / n_inv * 1e6, 3)
            row["speedup"] = round(ref_s / fast_s, 2)
            row["conformant"] = True
        rows.append(row)
        print(f"  N={n_inv:>9,}  vec {fast_s:8.3f}s "
              f"({row['vec_us_per_inv']:7.2f} us/inv)"
              + (f"  scalar {row['scalar_s']:8.3f}s  "
                 f"speedup {row['speedup']:5.1f}x  [bit-exact]"
                 if "speedup" in row else ""))
    return rows


OVERHEAD_SIZES = (10_000, 100_000)
NULL_OVERHEAD_LIMIT = 1.05
MONITORING_OVERHEAD_LIMIT = 1.10


def _time_obs_modes(suite, plan, seed: int, reps: int, inner: int = 1):
    """Best-of-``reps`` wall time per observability mode, with the modes
    *interleaved* round-robin inside each rep: container CPU throttling
    drifts on a seconds scale, so timing the modes in sequential blocks
    biases whichever block drew the slow window.  Interleaving exposes
    every mode to the same drift and the per-mode minimum compares
    like-for-like.

    Each timed sample is ``inner`` back-to-back engine runs: at N=10^4 a
    single run is ~20 ms, where scheduler noise and timer granularity
    put single-digit percent jitter on the very ratio being gated —
    batching makes the sample long enough to swamp it.  A full untimed
    warm-up round precedes the timed reps so no mode pays first-touch
    allocator/import costs inside a measurement."""
    import contextlib
    import gc

    from repro_torch.faas.backends import SimFaaSBackend
    from repro_torch.faas.engine import EngineConfig
    from repro_torch.faas.engine_vec import make_engine
    from repro_torch.obs import Observability, use_obs

    rec_obs = Observability.recording()
    modes = (("off", None), ("null", Observability.null()),
             ("recording", rec_obs),
             ("monitoring", Observability.monitoring()))
    best = {m: float("inf") for m, _ in modes}
    reports = {}
    n_recording_runs = 0
    gc_was = gc.isenabled()
    gc.disable()
    try:
        for rep in range(reps + 1):          # rep 0 is the warm-up round
            for mode, obs in modes:
                ctx = use_obs(obs) if obs is not None \
                    else contextlib.nullcontext()
                runs = 1 if rep == 0 else inner
                if mode == "recording":
                    n_recording_runs += runs
                engines = [make_engine(SimFaaSBackend(suite, seed=seed),
                                       EngineConfig(
                                           parallelism=PARALLELISM),
                                       engine="fast")
                           for _ in range(runs)]
                with ctx:
                    t0 = time.perf_counter()
                    for eng in engines:
                        reports[mode] = eng.run(plan)
                    dt = (time.perf_counter() - t0) / runs
                if rep > 0:
                    best[mode] = min(best[mode], dt)
    finally:
        if gc_was:
            gc.enable()
        gc.collect()
    return reports, best, len(rec_obs.tracer) // n_recording_runs


def run_trace_overhead(seed: int) -> list:
    """Time the vectorized engine off / null-tracer / recording-tracer on
    the same plan.  Digest equality across the three modes is asserted —
    the overhead numbers are only meaningful because the answers are
    bit-identical.  Both sizes always run (a 10^5 pass is ~2s): the gate
    needs the 10^5 row, where run time dwarfs timer jitter."""
    suite = synthetic_suite(seed=seed)
    rows = []
    for n in OVERHEAD_SIZES:
        plan = make_size_plan(suite, n, seed=seed)
        n_inv = len(plan.invocations)
        # small plans: more reps AND longer samples (inner back-to-back
        # runs per timing) — the 10^4 recording_ratio was flapping by
        # ~20% when each sample was a single ~20 ms run
        reps, inner = (9, 4) if n <= 10_000 else (5, 1)
        reports, best, events_per_run = _time_obs_modes(
            suite, plan, seed, reps, inner=inner)
        d = _digest(reports["off"])
        for mode in ("null", "recording", "monitoring"):
            if _digest(reports[mode]) != d:
                raise AssertionError(
                    f"obs conformance FAILED at N={n_inv}: {mode} digest "
                    f"{_digest(reports[mode])} != off {d}")
        row = {
            "n_invocations": n_inv,
            "off_us_per_inv": round(best["off"] / n_inv * 1e6, 3),
            "null_us_per_inv": round(best["null"] / n_inv * 1e6, 3),
            "recording_us_per_inv":
                round(best["recording"] / n_inv * 1e6, 3),
            "monitoring_us_per_inv":
                round(best["monitoring"] / n_inv * 1e6, 3),
            "null_ratio": round(best["null"] / best["off"], 4),
            "recording_ratio": round(best["recording"] / best["off"], 4),
            "monitoring_ratio":
                round(best["monitoring"] / best["off"], 4),
            "trace_events_per_run": events_per_run,
            "digest": d,
        }
        rows.append(row)
        print(f"  N={n_inv:>9,}  off {row['off_us_per_inv']:7.2f} us/inv  "
              f"null x{row['null_ratio']:.3f}  "
              f"recording x{row['recording_ratio']:.3f}  "
              f"monitoring x{row['monitoring_ratio']:.3f}  "
              f"({row['trace_events_per_run']} events/run)  [bit-exact]")
    return rows


def check_overhead(rows: list, limit: float = NULL_OVERHEAD_LIMIT,
                   mon_limit: float = None) -> int:
    # gate on the largest plan only: at 10^4 a best-of run is ~20 ms and
    # single-digit-percent jitter swamps the effect being measured
    if mon_limit is None:
        mon_limit = MONITORING_OVERHEAD_LIMIT
    gated = max(rows, key=lambda r: r["n_invocations"])
    rc = 0
    if gated["null_ratio"] > limit:
        print(f"null-tracer overhead gate FAILED at "
              f"N={gated['n_invocations']}: ratio {gated['null_ratio']} "
              f"> {limit}", file=sys.stderr)
        rc = 1
    if gated.get("monitoring_ratio", 0.0) > mon_limit:
        print(f"monitoring overhead gate FAILED at "
              f"N={gated['n_invocations']}: ratio "
              f"{gated['monitoring_ratio']} > {mon_limit}",
              file=sys.stderr)
        rc = 1
    if not rc:
        print(f"obs overhead gates OK "
              f"(null x{gated['null_ratio']} <= {limit}, monitoring "
              f"x{gated.get('monitoring_ratio', '-')} <= {mon_limit} at "
              f"N={gated['n_invocations']}, all modes bit-exact)")
    return rc


def check_baseline(rows: list, baseline_path: str) -> int:
    with open(baseline_path) as f:
        base_rows = {r["n_invocations"]: r
                     for r in json.load(f)["sizes"]}
    failures = []
    for row in rows:
        base = base_rows.get(row["n_invocations"])
        if base is None:
            continue
        b, c = base["vec_us_per_inv"], row["vec_us_per_inv"]
        if b > 0 and c / b > GATE_FACTOR:
            failures.append(
                f"N={row['n_invocations']}: vec {c} us/inv vs baseline {b} "
                f"(>{GATE_FACTOR}x)")
        if "speedup" in row and "speedup" in base:
            if row["speedup"] < base["speedup"] / GATE_FACTOR:
                failures.append(
                    f"N={row['n_invocations']}: speedup {row['speedup']}x "
                    f"vs baseline {base['speedup']}x (fell >{GATE_FACTOR}x)")
    if failures:
        print("engine perf regression gate FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(f"engine perf gate OK ({len(rows)} sizes, gate {GATE_FACTOR}x, "
          f"all sampled sizes bit-exact)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="CI mode: N up to 1e4 only")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="write/update the baseline JSON")
    ap.add_argument("--check-baseline", default=None, metavar="FILE")
    ap.add_argument("--trace-overhead", action="store_true",
                    help="measure the off/null/recording observability "
                         "overhead instead of the scaling profile; gates "
                         f"null-tracer overhead at {NULL_OVERHEAD_LIMIT}x")
    args = ap.parse_args(argv)

    if args.trace_overhead:
        print(f"observability overhead: {N_BENCH} benchmarks, "
              f"parallelism {PARALLELISM}, lambda profile")
        orows = run_trace_overhead(args.seed)
        if args.out:
            try:
                with open(args.out) as f:
                    doc = json.load(f)
            except FileNotFoundError:
                doc = {"schema": 1, "scenario": "engine_scaling",
                       "seed": args.seed,
                       "python": platform.python_version(),
                       "machine": platform.machine()}
            doc["obs_overhead"] = orows
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
                f.write("\n")
            print(f"merged obs_overhead into {args.out}")
        return check_overhead(orows)

    print(f"engine scaling ({'quick' if args.quick else 'full'}): "
          f"{N_BENCH} benchmarks, parallelism {PARALLELISM}, "
          f"R={REPEATS}, lambda profile")
    rows = run_profile(args.quick, args.seed)

    if args.out:
        doc = {
            "schema": 1,
            "scenario": "engine_scaling",
            "seed": args.seed,
            "python": platform.python_version(),
            "machine": platform.machine(),
            "sizes": rows,
        }
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}")

    if args.check_baseline:
        return check_baseline(rows, args.check_baseline)
    return 0


if __name__ == "__main__":
    sys.exit(main())
