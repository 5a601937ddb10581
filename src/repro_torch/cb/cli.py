"""Command-line entry point for the continuous-benchmarking pipeline.

Runs a (synthetic) commit stream through the pipeline on one or more
provider profiles, persists the history store (and optional SQLite
export), and prints one JSON summary line per provider/mode — the CI
smoke job runs exactly this and uploads the history as a build artifact.

    PYTHONPATH=src python -m repro_torch.cb.cli --commits 6 \
        --providers lambda,gcf,azure --mode selective_cached \
        --history out/history.jsonl --seed 1

The kernel-duet suite times the port's PyTorch duets on the CUDA card
(`--device cpu` runs them on the host instead; without a card and without
it the run raises):

    PYTHONPATH=src python -m repro_torch.cb.cli --suite kernels \
        --n-calls 12 --repeats 1 --parallelism 1

Service mode (benchmarking-as-a-service): `--jobs N` submits N concurrent
tenant commit streams to one shared `BenchmarkService` per provider
instead of running inline; `--deadline` / `--budget` route every
commit-job through the deadline/cost planner, which picks the provider,
memory, fleet size, and repeat plan — and **fails loudly** (exit code 2)
when no candidate configuration is feasible.  Passing ``--engine fast``
explicitly is strict: if an observer/backend combination forces the
vectorized core to degrade to the scalar loop, the run exits with code 3
and names the reason instead of silently falling back:

    PYTHONPATH=src python -m repro_torch.cb.cli --commits 6 --jobs 8 \
        --providers lambda --seed 1
    PYTHONPATH=src python -m repro_torch.cb.cli --commits 6 \
        --deadline 900 --budget 0.25 --seed 1

Failure conditions can co-occur (a multi-provider run may hit an
infeasible plan on one provider, a strict-fast fallback on another, and
an SLO breach overall); the process exit code is then resolved
deterministically by `EXIT_PRECEDENCE`: infeasible (2) beats engine
fallback (3) beats SLO breach (4).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.cb.commits import StreamConfig, synthetic_stream
from repro_torch.cb.history import HistoryStore
from repro_torch.cb.pipeline import MODES, Pipeline, PipelineConfig
from repro_torch.cb.registry import SyntheticSuite, get_suite

EXIT_INFEASIBLE = 2
EXIT_FALLBACK = 3       # `--engine fast` was explicit but the run degraded
EXIT_BREACH = 4         # `--slo` was armed and an objective breached

#: Deterministic winner when failure conditions co-occur, strongest
#: first.  Infeasible (2) outranks everything: the planner refused, so
#: nothing downstream is meaningful.  Fallback (3) outranks breach (4):
#: a strict `--engine fast` run that degraded produced its numbers on
#: the wrong core, so an SLO verdict measured on them is already
#: suspect.  `main` resolves through this table from a single return
#: site.
EXIT_PRECEDENCE = (EXIT_INFEASIBLE, EXIT_FALLBACK, EXIT_BREACH)


def resolve_exit_code(*codes: int) -> int:
    """Collapse co-occurring failure exit codes into one winner.

    Takes any number of per-condition codes (0 = condition absent) and
    returns the highest-precedence live one per ``EXIT_PRECEDENCE``; 0
    when none fired.  A non-zero code outside the table is never
    swallowed — it wins over 0 in argument order — so a future code
    added to one caller fails loudly instead of vanishing.
    """
    live = [c for c in codes if c]
    if not live:
        return 0
    for known in EXIT_PRECEDENCE:
        if known in live:
            return known
    return live[0]


def _stream_for(args, suite, seed: int):
    names = suite.benchmark_names()
    eff = suite.measurable_names() if isinstance(suite, SyntheticSuite) \
        else names
    quiet = suite.quiet_names() if isinstance(suite, SyntheticSuite) \
        else eff
    return synthetic_stream(
        names, StreamConfig(n_commits=args.commits, seed=seed),
        effectable=eff, drift_candidates=quiet)


def _run_service(args, history, providers, modes) -> int:
    """--jobs/--deadline/--budget: the service path.

    Returns the resolved exit code.  Every (provider, mode) cell runs
    even after an earlier cell failed; conditions accumulate and
    collapse through `resolve_exit_code`, so the winner is fixed by
    `EXIT_PRECEDENCE`, never by loop iteration order.
    """
    from repro_torch.service import (AdmissionError, BenchmarkService,
                                     DeadlineCostPlanner, PlannerConfig,
                                     ServiceConfig)
    if args.suite == "kernels":
        print("service mode needs a simulated suite (kernels run "
              "realtime); drop --jobs/--deadline/--budget", file=sys.stderr)
        return EXIT_INFEASIBLE
    n_tenants = max(args.jobs, 1)
    planned = args.deadline is not None or args.budget is not None
    codes = []
    for provider in providers:
        # the planner is constrained to the loop's provider so each
        # summary line answers "what would this provider cost" instead of
        # re-running one global choice once per listed provider
        planner = DeadlineCostPlanner(PlannerConfig(
            providers=(provider,), include_vm=False)) if planned else None
        for mode in modes:
            service = BenchmarkService(
                ServiceConfig(parallelism=args.parallelism,
                              seed=args.seed, engine=args.engine),
                planner=planner)
            pipelines = []
            try:
                for t in range(n_tenants):
                    seed = args.seed + 7919 * t
                    tenant = f"tenant{t:02d}"
                    suite = get_suite(args.suite)
                    commits, drift = _stream_for(args, suite, seed)
                    cfg = PipelineConfig(
                        suite=args.suite, provider=provider, mode=mode,
                        n_calls=args.n_calls,
                        repeats_per_call=args.repeats,
                        parallelism=args.parallelism, seed=seed,
                        max_staleness=args.max_staleness)
                    tenant_suite = get_suite(args.suite)
                    # the shared history store is scanned per (suite,
                    # provider, mode): tag the suite per tenant so the
                    # regression detector never sums unrelated tenant
                    # streams into one CUSUM series
                    tenant_suite.name = f"{tenant_suite.name}@{tenant}"
                    pipe = Pipeline(tenant_suite, cfg, history=history)
                    pending = pipe.submit_stream(
                        commits, service, tenant=tenant,
                        deadline_s=args.deadline, budget_usd=args.budget)
                    pipelines.append((pipe, pending))
            except AdmissionError as exc:
                print(f"infeasible: {exc}", file=sys.stderr)
                codes.append(EXIT_INFEASIBLE)
                continue
            from repro_torch.faas.engine_vec import (get_fallback_log,
                                              reset_fallback_log)
            reset_fallback_log()
            rep = service.run()
            fallbacks = get_fallback_log()
            if getattr(args, "strict_fast", False) and fallbacks:
                print("--engine fast was requested but the run degraded "
                      "to the scalar loop:", file=sys.stderr)
                for reason in sorted(set(fallbacks)):
                    print(f"  {reason}", file=sys.stderr)
                # record the condition but still print the summary: the
                # numbers exist, the exit code says how far to trust them
                codes.append(EXIT_FALLBACK)
            reports = [p.collect_service(pend) for p, pend in pipelines]
            summary = {
                "suite": args.suite, "provider": provider, "mode": mode,
                "service": True, "tenants": n_tenants,
                "jobs": len(rep.results),
                "invocations": rep.total_invocations,
                "cost_usd": round(rep.total_cost_usd, 4),
                "makespan_min": round(rep.makespan_s / 60.0, 2),
                "p95_latency_min": round(rep.p95_latency_s() / 60.0, 2),
                "fairness_jain": round(rep.fairness, 3),
                "cold_starts": rep.cold_starts,
                "preempted": rep.preempted_jobs,
                "flagged": sum(r.total_flagged for r in reports),
                "digest": rep.digest(),
            }
            if planned and rep.results:
                r0 = rep.results[0]
                summary["planned_provider"] = r0.provider
                summary["planned_memory_mb"] = r0.memory_mb
            print(json.dumps(summary, sort_keys=True))
    return resolve_exit_code(*codes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--suite", default="synthetic")
    ap.add_argument("--commits", type=int, default=20,
                    help="commit-stream length (incl. the baseline)")
    ap.add_argument("--providers", default="lambda",
                    help="comma-separated provider profiles")
    ap.add_argument("--mode", default="selective_cached",
                    choices=MODES + ("all",))
    ap.add_argument("--n-calls", type=int, default=15)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--parallelism", type=int, default=150)
    ap.add_argument("--engine", default=None,
                    choices=("fast", "reference"),
                    help="scheduler core: vectorized (default) or the "
                         "scalar reference loop — reports are "
                         "bit-identical.  Passing `fast` explicitly is "
                         "strict: a run that silently degrades to the "
                         "scalar loop exits non-zero")
    ap.add_argument("--max-staleness", type=int, default=5)
    ap.add_argument("--adaptive", action="store_true",
                    help="CI-width early stopping inside each commit run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the kernel suite's duets run (cuda or "
                         "cpu); simulated suites ignore it")
    ap.add_argument("--jobs", type=int, default=0, metavar="N",
                    help="submit N concurrent tenant streams to the "
                         "benchmarking service instead of running inline")
    ap.add_argument("--deadline", type=float, default=None, metavar="S",
                    help="per-commit-job virtual-time deadline (seconds); "
                         "the planner picks the configuration; exit 2 "
                         "when no feasible plan exists")
    ap.add_argument("--budget", type=float, default=None, metavar="USD",
                    help="per-commit-job billing budget; over-budget jobs "
                         "are preempted; exit 2 when no feasible plan")
    ap.add_argument("--history", default=None,
                    help="history-store JSONL path (appended across runs)")
    ap.add_argument("--sqlite", default=None,
                    help="also export the history to this SQLite file")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a virtual-time trace and write it as "
                         "Chrome trace_event JSON (open in Perfetto / "
                         "chrome://tracing)")
    ap.add_argument("--metrics-out", default=None, metavar="OUT.json",
                    help="write the metrics registry snapshot "
                         "(render with `python -m repro_torch.obs.report`)")
    ap.add_argument("--slo", nargs="?", const=True, default=None,
                    metavar="SLOS.json",
                    help="arm live SLO monitoring (stock objectives, or a "
                         "JSON spec file); prints the health verdict and "
                         "exits 4 on an SLO breach")
    ap.add_argument("--health-out", default=None, metavar="OUT.json",
                    help="write the machine-readable health verdict "
                         "(repro_torch.obs.watch schema; requires --slo)")
    args = ap.parse_args(argv)
    # `--engine fast` given explicitly arms the strict no-fallback gate;
    # the bare default still prefers the vectorized core but tolerates
    # designed scalar fallbacks (e.g. chaos runs)
    args.strict_fast = args.engine == "fast"
    if args.engine is None:
        args.engine = "fast"

    from repro_torch.faas.engine_vec import set_default_engine
    set_default_engine(args.engine)

    obs = None
    if args.slo or args.trace or args.metrics_out:
        from repro_torch.obs import Observability, load_slos, set_obs
        if args.slo:
            specs = None if args.slo is True else load_slos(args.slo)
            obs = Observability.monitoring(specs)
        else:
            obs = Observability.recording()
        set_obs(obs)

    service_mode = args.jobs > 0 or args.deadline is not None \
        or args.budget is not None
    suite_kwargs = {"device": args.device} if args.suite == "kernels" else {}
    if args.suite == "kernels" and not service_mode:
        # the kernel suite registers on import of its module
        from repro_torch.benchmarks.kernel_bench import kernel_commits
        commits, drift = kernel_commits(), None
    elif not service_mode:
        commits, drift = _stream_for(args, get_suite(args.suite), args.seed)
    history = HistoryStore(args.history)

    modes = MODES if args.mode == "all" else (args.mode,)
    providers = (["local"] if args.suite == "kernels"
                 else args.providers.split(","))

    code = 0
    if service_mode:
        if args.adaptive:
            ap.error("--adaptive is an inline-run feature; drop it in "
                     "service mode")
        code = _run_service(args, history, providers, modes)
    else:
        for provider in providers:
            for mode in modes:
                cfg = PipelineConfig(
                    suite=args.suite, provider=provider, mode=mode,
                    n_calls=args.n_calls, repeats_per_call=args.repeats,
                    parallelism=args.parallelism, seed=args.seed,
                    max_staleness=args.max_staleness,
                    adaptive=args.adaptive, engine=args.engine)
                rep = Pipeline(get_suite(args.suite, **suite_kwargs), cfg,
                               history=history).run_stream(commits)
                summary = {
                    "suite": args.suite, "provider": provider, "mode": mode,
                    "commits": len(rep.commits),
                    "invocations": rep.total_invocations,
                    "cost_usd": round(rep.total_cost, 4),
                    "wall_min": round(rep.total_wall_seconds / 60.0, 2),
                    "cache_hits": rep.cache_hits,
                    "flagged": rep.total_flagged,
                    "events": [str(e) for e in rep.events],
                }
                if drift is not None:
                    summary["drift_ground_truth"] = (
                        f"{drift.benchmark} +{drift.total_pct:.1f}% over "
                        f"commits {drift.start}..{drift.end}")
                print(json.dumps(summary, sort_keys=True))
    if args.history:
        print(f"history: {len(history)} records -> {args.history}")
    if args.sqlite:
        history.to_sqlite(args.sqlite)
        print(f"sqlite export -> {args.sqlite}")
    if obs is not None:
        if args.trace:
            obs.export_trace(args.trace)
            print(f"trace: {len(obs.tracer)} events -> {args.trace}")
        if args.metrics_out:
            obs.export_metrics(args.metrics_out)
            print(f"metrics -> {args.metrics_out}")
        if obs.monitor is not None:
            health = obs.health()
            print(f"slo verdict: {health['verdict']} "
                  f"({len(health['alerts'])} alerts, "
                  f"{len(health['incidents'])} incidents)", file=sys.stderr)
            if args.health_out:
                with open(args.health_out, "w") as f:
                    json.dump(health, f, indent=1, sort_keys=True)
                print(f"health -> {args.health_out}", file=sys.stderr)
            breach = EXIT_BREACH if health["verdict"] == "breach" else 0
            code = resolve_exit_code(code, breach)
    return code


if __name__ == "__main__":
    raise SystemExit(main())
