"""Benchmark harness: one function per paper table/figure.

Prints ``name,us_per_call,derived`` CSV (derived = compact JSON of the
table's rows) followed by a human-readable summary block per table.

    PYTHONPATH=src python -m repro_torch.benchmarks.run
        [--tables aa,baseline,...] [--skip-real] [--device cuda|cpu]
        [--roofline FILE] [--seed N] [--engine fast|reference] [--jobs N]

The port's twin of the JAX package's ``benchmarks/run.py``: the same
tables, rows and exit codes over the port's copies of the NumPy layers.
The real-timing kernel duets (``repro_torch.benchmarks.kernel_bench``,
whose SSD duet is the hand-written K2 kernel on the card) run on
``--device``, the CUDA card unless ``--device cpu`` is given; asking for
an absent card raises before any table runs.  ``--skip-real`` leaves them
out, and the run stays on the host.

``--jobs N`` runs the multi-tenant benchmarking-as-a-service scenario
(N concurrent commit-stream tenants on one shared fleet) instead of the
tables; with ``--engine fast`` given explicitly the run exits non-zero
if anything forces the vectorized core to degrade to the scalar loop.

Exit codes follow the shared contract in ``repro_torch.cb.cli``: 3 for a
strict-fast engine fallback, 4 for an armed-SLO breach, and when both
fire in one run the winner comes from ``EXIT_PRECEDENCE`` (infeasible 2
beats fallback 3 beats breach 4).
"""
from __future__ import annotations

import argparse
import json
import sys


# the roofline row when --roofline names no file
NO_DRYRUN = ("no dry-run results yet: pass a JSONL written by the port's dry run "
             "(python -m repro_torch.launch.dryrun --both-meshes --out FILE) or by "
             "the JAX package's dry run (python -m repro.launch.dryrun, the same "
             "keys) with --roofline FILE")


def _write_obs(args, obs):
    """Export trace/metrics/health; returns the health dict (None when
    monitoring is not armed) so the caller can fold an SLO breach into
    the exit code."""
    if obs is None:
        return None
    if args.trace:
        obs.export_trace(args.trace)
        print(f"\ntrace: {len(obs.tracer)} events -> {args.trace}")
    if args.metrics_out:
        obs.export_metrics(args.metrics_out)
        print(f"metrics -> {args.metrics_out}")
    health = None
    if obs.monitor is not None:
        health = obs.health()
        print(f"slo verdict: {health['verdict']} "
              f"({len(health['alerts'])} alerts, "
              f"{len(health['incidents'])} incidents)")
        if args.health_out:
            with open(args.health_out, "w") as f:
                json.dump(health, f, indent=1, sort_keys=True)
            print(f"health -> {args.health_out}")
    return health


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tables", default=None,
                    help="comma-separated subset of table names")
    ap.add_argument("--skip-real", action="store_true",
                    help="skip the real-timing kernel duets (slow on CPU)")
    ap.add_argument("--device", default="cuda",
                    help="device of the real-timing kernel duets (cuda, or "
                         "cpu)")
    ap.add_argument("--roofline", default="results/dryrun_torch.jsonl",
                    help="dry-run JSONL to summarize (if present): the port's "
                         "(python -m repro_torch.launch.dryrun), or the JAX "
                         "package's, which has the same keys")
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed offsetting every table's experiment "
                         "seeds (0 replays the historical tables)")
    ap.add_argument("--engine", default=None,
                    choices=("fast", "reference"),
                    help="simulation scheduler core: vectorized (default) "
                         "or the scalar reference loop — every table is "
                         "bit-identical under both.  Passing `fast` "
                         "explicitly is strict: a --jobs run that "
                         "degrades to the scalar loop exits non-zero")
    ap.add_argument("--jobs", type=int, default=0, metavar="N",
                    help="instead of the paper tables, run the "
                         "multi-tenant benchmarking-as-a-service scenario "
                         "with N concurrent commit-stream tenants on one "
                         "shared fleet (honors --engine through the "
                         "service scheduler) and print its summary JSON")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a virtual-time trace of every table run "
                         "and write Chrome trace_event JSON (Perfetto)")
    ap.add_argument("--metrics-out", default=None, metavar="OUT.json",
                    help="write the metrics registry snapshot "
                         "(render with `python -m repro_torch.obs.report`)")
    ap.add_argument("--slo", nargs="?", const=True, default=None,
                    metavar="SLOS.json",
                    help="arm live SLO monitoring (stock objectives, or a "
                         "JSON spec file) on top of recording; prints the "
                         "health verdict at the end")
    ap.add_argument("--health-out", default=None, metavar="OUT.json",
                    help="write the machine-readable health verdict "
                         "(repro_torch.obs.watch schema; requires --slo)")
    args = ap.parse_args(argv)
    strict_fast = args.engine == "fast"    # explicit ask = strict gate
    if args.engine is None:
        args.engine = "fast"

    from repro_torch.faas.engine_vec import set_default_engine
    set_default_engine(args.engine)
    # one exit-code contract across both entry points: the precedence
    # table and resolver live in repro_torch.cb.cli
    from repro_torch.cb.cli import (EXIT_BREACH, EXIT_FALLBACK,
                                    resolve_exit_code)

    obs = None
    if args.slo or args.trace or args.metrics_out:
        from repro_torch.obs import Observability, load_slos, set_obs
        if args.slo:
            specs = None if args.slo is True else load_slos(args.slo)
            obs = Observability.monitoring(specs)
        else:
            obs = Observability.recording()
        set_obs(obs)

    if args.jobs > 0:
        from dataclasses import asdict

        from repro_torch.core.experiment import run_multi_tenant_experiment
        from repro_torch.faas.engine_vec import (get_fallback_log,
                                                 reset_fallback_log)
        reset_fallback_log()
        r = run_multi_tenant_experiment(args.jobs, provider="lambda",
                                        seed=args.seed, engine=args.engine)
        print(json.dumps(asdict(r), sort_keys=True))
        fallbacks = get_fallback_log()
        fb = 0
        if strict_fast and fallbacks:
            print("--engine fast was requested but the service run "
                  "degraded to the scalar loop:", file=sys.stderr)
            for reason in sorted(set(fallbacks)):
                print(f"  {reason}", file=sys.stderr)
            fb = EXIT_FALLBACK
        health = _write_obs(args, obs)
        breach = (EXIT_BREACH if health is not None
                  and health["verdict"] == "breach" else 0)
        code = resolve_exit_code(fb, breach)
        if code:
            sys.exit(code)
        return

    import repro_torch.benchmarks.paper_tables as paper_tables
    if args.seed:
        paper_tables.set_base_seed(args.seed)
    selected = None if args.tables is None else set(args.tables.split(","))
    tables = [(fn.__name__.replace("table_", ""), fn)
              for fn in paper_tables.ALL_TABLES]
    if not args.skip_real and (not selected or "kernel_duets" in selected):
        from repro_torch.benchmarks.kernel_bench import table_kernel_duets
        from repro_torch.models.lm import resolve_device
        device = resolve_device(args.device)    # an absent card raises here
        tables.append(("kernel_duets",
                       lambda: table_kernel_duets(device=device)))

    from repro_torch.benchmarks.roofline_table import table_roofline

    results = []
    for name, fn in tables:
        if selected and name not in selected:
            continue
        try:
            name, us, rows = fn()
            results.append((name, us, rows))
            print(f"{name},{us:.0f},{json.dumps(rows, sort_keys=True)}")
        except Exception as e:  # keep the harness running
            print(f"{name},-1,{json.dumps({'error': str(e)})}")

    if selected is None or "roofline" in selected:
        try:
            name, us, rows = table_roofline(args.roofline)
            results.append((name, us, rows))
            print(f"{name},{us:.0f},{json.dumps(rows, sort_keys=True)}")
        except FileNotFoundError:
            print("roofline,-1," + json.dumps({"error": NO_DRYRUN}))

    print()
    print("=" * 72)
    for name, us, rows in results:
        print(f"\n## {name}  (harness {us/1e6:.1f}s)")
        for k, v in rows.items():
            print(f"    {k:36s} {v}")

    health = _write_obs(args, obs)
    if health is not None and health["verdict"] == "breach":
        sys.exit(resolve_exit_code(EXIT_BREACH))


if __name__ == "__main__":
    main()
