"""Continuous benchmarking in CI (the paper's headline use case).

Simulates the full ElastiBench flow for a code change: run the suite on the
elastic FaaS platform against the previous release, analyze with bootstrap
CIs, and fail the "pipeline" if a regression above the noise floor appears.
Then prints the time/cost comparison against the VM-based baseline, and
finally drives a whole *commit stream* through the continuous-benchmarking
pipeline (repro_torch.cb): fingerprint selection + result caching vs naive
full-suite-per-commit runs, with history-level drift detection.

    PYTHONPATH=src python -m repro_torch.examples.continuous_benchmarking

The port's twin of the JAX package's ``examples/continuous_benchmarking.py``
(host only: the platform is simulated in virtual time); it prints what the
JAX example prints, line for line.
"""
from repro_torch.cb import (Pipeline, PipelineConfig, StreamConfig, SyntheticSuite,
                            synthetic_stream)
from repro_torch.core.experiment import (run_adaptive_experiment,
                                         run_faas_experiment, run_vm_experiment,
                                         victoriametrics_like_suite)
from repro_torch.core.stats import compare_experiments, detection_set_delta


def main():
    suite = victoriametrics_like_suite()

    print("== simulating VM-based baseline (the old, slow way) ==")
    vm = run_vm_experiment("vm_baseline", suite)
    print(f"   wall {vm.report.wall_seconds/3600:.1f} h, "
          f"${vm.report.cost_dollars:.2f}, "
          f"{vm.n_changed} changes detected\n")

    print("== ElastiBench run on the elastic FaaS platform ==")
    fa = run_faas_experiment("ci_run", suite, n_calls=45, repeats_per_call=1,
                             parallelism=150, seed=13)
    print(f"   wall {fa.report.wall_seconds/60:.1f} min, "
          f"${fa.report.cost_dollars:.2f}, "
          f"{fa.n_changed} changes detected, "
          f"{fa.report.cold_starts} cold starts\n")

    cmp = compare_experiments(fa.changes, vm.changes)
    print(f"agreement with the VM baseline: {cmp.agreement*100:.1f}% "
          f"({cmp.n_common} comparable benchmarks)")
    speedup = vm.report.wall_seconds / fa.report.wall_seconds
    print(f"speedup {speedup:.0f}x, cost "
          f"${fa.report.cost_dollars:.2f} vs ${vm.report.cost_dollars:.2f}\n")

    print("== adaptive stopping: same detection, less budget ==")
    ad = run_adaptive_experiment("ci_adaptive", suite, n_calls=45,
                                 repeats_per_call=1, parallelism=150, seed=13)
    only_f, only_a = detection_set_delta(fa.changes, ad.changes)
    s = ad.adaptive
    print(f"   wall {ad.report.wall_seconds/60:.1f} min, "
          f"${ad.report.cost_dollars:.2f}, "
          f"{ad.invocations_used} invocations "
          f"(fixed used {len(fa.report.billed_seconds)}), "
          f"{len(s.stopped_early)} benchmarks stopped early, "
          f"{s.invocations_added} re-allocated to noisy ones")
    print(f"   detection delta vs fixed run: {len(only_f) + len(only_a)} "
          f"benchmarks\n")

    print("== same suite on other provider profiles (shared engine) ==")
    for provider in ("gcf", "azure"):
        pr = run_faas_experiment(f"ci_{provider}", suite, n_calls=45,
                                 repeats_per_call=1, parallelism=150,
                                 seed=13, provider=provider)
        print(f"   {provider:6s} wall {pr.report.wall_seconds/60:.1f} min, "
              f"${pr.report.cost_dollars:.2f}, "
              f"{pr.n_changed} changes, {pr.report.cold_starts} cold starts")
    print()

    regressions = [c for c in fa.changes.values()
                   if c.changed and c.median_diff_pct > 7.0]
    if regressions:
        print("CI GATE: FAIL — regressions above the 7% reliability floor:")
        for r in sorted(regressions, key=lambda c: -c.median_diff_pct)[:10]:
            print(f"   {r.benchmark}: {r.median_diff_pct:+.1f}% "
                  f"[{r.ci_low:+.1f}, {r.ci_high:+.1f}]")
    else:
        print("CI GATE: PASS — no regression above the reliability floor")

    print("\n== commit stream: selection + caching vs full-suite runs ==")
    sim = SyntheticSuite(suite)
    commits, drift = synthetic_stream(
        sim.benchmark_names(), StreamConfig(n_commits=12, seed=7),
        effectable=sim.measurable_names(),
        drift_candidates=sim.quiet_names())
    print(f"   ground truth: {drift.benchmark} drifts "
          f"+{drift.per_commit_pct}%/commit over commits "
          f"{drift.start}..{drift.end} (total +{drift.total_pct:.1f}%)")
    reports = {}
    for mode in ("full", "selective_cached"):
        rep = Pipeline(SyntheticSuite(suite),
                       PipelineConfig(mode=mode, seed=7)).run_stream(commits)
        reports[mode] = rep
        print(f"   {mode:16s} {rep.total_invocations:6d} invocations, "
              f"${rep.total_cost:.2f}, "
              f"{rep.total_wall_seconds/60:.1f} min platform time, "
              f"{rep.cache_hits} cache hits")
    full, cached = reports["full"], reports["selective_cached"]
    print(f"   saved {(1 - cached.total_invocations/full.total_invocations)*100:.0f}% "
          f"invocations, {(1 - cached.total_cost/full.total_cost)*100:.0f}% cost")
    print("   history-level regression events (top 3 + the hidden drift):")
    drift_ev = [e for e in cached.events if e.benchmark == drift.benchmark]
    for e in cached.events[:3] + drift_ev:
        mark = "  <-- the hidden drift" if e.benchmark == drift.benchmark \
            else ""
        print(f"      {e}{mark}")


if __name__ == "__main__":
    main()
