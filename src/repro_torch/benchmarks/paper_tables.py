"""One function per paper table/figure (§6).  Each returns (name, rows) and
the harness prints ``name,us_per_call,derived`` CSV lines plus a human
summary.  All simulated experiments are deterministic (fixed seeds).

Paper targets annotated inline; EXPERIMENTS.md records actuals vs targets.

The port's twin of the JAX package's ``benchmarks/paper_tables.py``: the
same tables over the port's copies of the NumPy layers, row for row.
"""
from __future__ import annotations

import os
import time

import numpy as np

from repro_torch.core.experiment import (aa_suite, detection_accuracy,
                                         run_adaptive_experiment,
                                         run_faas_experiment,
                                         run_multi_tenant_experiment,
                                         run_pipeline_experiment,
                                         run_service_pareto_experiment,
                                         run_vm_experiment,
                                         victoriametrics_like_suite)
from repro_torch.core.stats import (bootstrap_median_ci, compare_experiments,
                                    detection_set_delta, relative_diffs,
                                    repeats_for_ci_parity)

_SEED_OFFSETS = {"aa": 21, "baseline": 11, "replication": 12, "lowmem": 14,
                 "single": 13, "ci": 15, "vm": 1, "suite": 42, "pipeline": 31,
                 "service": 33, "tenants": 34, "chaos": 37}

BASE_SEED = 0
SEEDS = dict(_SEED_OFFSETS)

_cache = {}

# the checkout's root (src/repro_torch/benchmarks/ is three levels below
# it), where the committed BENCH_*.json baselines live
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def set_base_seed(base: int) -> None:
    """`--seed` plumbing: offset every experiment seed by `base` so each
    table is reproducible (and perturbable) from the command line.  Base 0
    replays the historical tables bit-for-bit."""
    global BASE_SEED
    BASE_SEED = int(base)
    SEEDS.clear()
    SEEDS.update({k: v + BASE_SEED for k, v in _SEED_OFFSETS.items()})
    _cache.clear()


def _suite():
    if "suite" not in _cache:
        _cache["suite"] = victoriametrics_like_suite(seed=SEEDS["suite"])
    return _cache["suite"]


def _original():
    if "orig" not in _cache:
        _cache["orig"] = run_vm_experiment("original", _suite(),
                                           seed=SEEDS["vm"])
    return _cache["orig"]


def _baseline():
    if "base" not in _cache:
        _cache["base"] = run_faas_experiment("baseline", _suite(),
                                             seed=SEEDS["baseline"])
    return _cache["base"]


def table_aa():
    """§6.2.1 A/A: 90/106 executed, 0 performance changes, ~8 min, ~$1."""
    t0 = time.perf_counter()
    res = run_faas_experiment("aa", aa_suite(_suite()), seed=SEEDS["aa"])
    harness_us = (time.perf_counter() - t0) * 1e6
    diffs = [abs(c.median_diff_pct) for c in res.changes.values()]
    rows = {
        "executed": res.n_executed, "target_executed": 90,
        "false_changes": res.n_changed, "target_false_changes": 0,
        "median_abs_diff_pct": round(float(np.median(diffs)), 3),
        "max_abs_diff_pct": round(float(np.max(diffs)), 2),
        "wall_min": round(res.report.wall_seconds / 60, 2),
        "cost_usd": round(res.report.cost_dollars, 2),
    }
    return "aa", harness_us, rows


def table_baseline():
    """§6.2.2: 95.65% agreement w/ original dataset; median change 4.71%."""
    t0 = time.perf_counter()
    base = _baseline()
    orig = _original()
    cmp = compare_experiments(base.changes, orig.changes)
    harness_us = (time.perf_counter() - t0) * 1e6
    chg = [abs(c.median_diff_pct) for c in base.changes.values() if c.changed]
    rows = {
        "agreement_pct": round(cmp.agreement * 100, 2), "target_agreement_pct": 95.65,
        "n_common": cmp.n_common,
        "opposite_direction": len(cmp.opposite_direction), "target_opposite": 3,
        "median_change_pct": round(float(np.median(chg)), 2), "target_median_change_pct": 4.71,
        "max_change_pct": round(float(np.max(chg)), 1), "target_max_change_pct": 116.0,
        "one_sided_cov_pct": round(cmp.one_sided_a_in_b * 100, 1), "target_one_sided": 86.96,
        "two_sided_cov_pct": round(cmp.two_sided * 100, 1), "target_two_sided": 50.0,
        "wall_min": round(base.report.wall_seconds / 60, 2),
        "cost_usd": round(base.report.cost_dollars, 2),
    }
    return "baseline_vs_original", harness_us, rows


def table_replication():
    """§6.2.3: replication has the same agreement w/ original; disagrees
    with baseline only on small effects (max possible change ~5.25%)."""
    t0 = time.perf_counter()
    rep = run_faas_experiment("replication", _suite(), seed=SEEDS["replication"],
                              start_time_s=9900.0)
    cmp_o = compare_experiments(rep.changes, _original().changes)
    cmp_b = compare_experiments(rep.changes, _baseline().changes)
    harness_us = (time.perf_counter() - t0) * 1e6
    poss = [p[1] for p in cmp_b.possible_changes]
    rows = {
        "agreement_with_original_pct": round(cmp_o.agreement * 100, 2),
        "disagree_with_baseline_pct": round((1 - cmp_b.agreement) * 100, 1),
        "max_possible_change_pct": round(max(poss), 2) if poss else 0.0,
        "target_max_possible_change_pct": 5.25,
        "wall_min": round(rep.report.wall_seconds / 60, 2),
        "cost_usd": round(rep.report.cost_dollars, 2),
    }
    return "replication", harness_us, rows


def table_lowmem():
    """§6.2.4: 1024 MB -> fewer executed (81), agreement holds."""
    t0 = time.perf_counter()
    low = run_faas_experiment("lowmem", _suite(), memory_mb=1024,
                              seed=SEEDS["lowmem"])
    cmp_o = compare_experiments(low.changes, _original().changes)
    cmp_b = compare_experiments(low.changes, _baseline().changes)
    harness_us = (time.perf_counter() - t0) * 1e6
    poss = [p[1] for p in cmp_b.possible_changes]
    rows = {
        "executed": low.n_executed, "target_executed": 81,
        "timeouts": low.report.timeouts,
        "agreement_with_original_pct": round(cmp_o.agreement * 100, 2),
        "disagree_with_baseline_pct": round((1 - cmp_b.agreement) * 100, 1),
        "target_disagree_pct": 20.0,
        "max_possible_change_pct": round(max(poss), 2) if poss else 0.0,
        "wall_min": round(low.report.wall_seconds / 60, 2),
        "cost_usd": round(low.report.cost_dollars, 2), "target_cost_usd": 0.69,
    }
    return "lower_memory", harness_us, rows


def table_single_repeat():
    """§6.2.5: 45x1 instead of 15x3; cheapest config ($0.49, ~17 min)."""
    t0 = time.perf_counter()
    single = run_faas_experiment("single", _suite(), n_calls=45,
                                 repeats_per_call=1, seed=SEEDS["single"])
    cmp_o = compare_experiments(single.changes, _original().changes)
    cmp_b = compare_experiments(single.changes, _baseline().changes)
    harness_us = (time.perf_counter() - t0) * 1e6
    poss = [p[1] for p in cmp_b.possible_changes]
    rows = {
        "agreement_with_original_pct": round(cmp_o.agreement * 100, 2),
        "disagree_with_baseline_pct": round((1 - cmp_b.agreement) * 100, 1),
        "max_possible_change_pct": round(max(poss), 2) if poss else 0.0,
        "target_max_possible_change_pct": 5.09,
        "wall_min": round(single.report.wall_seconds / 60, 2),
        "cost_usd": round(single.report.cost_dollars, 2),
        "target_cost_usd": 0.49,
    }
    return "single_repeat", harness_us, rows


def table_possible_changes():
    """§6.2.6 Fig. 6: max performance difference on any disagreement between
    the four FaaS experiments; median ~1.58%, p75 ~3.06%, max ~7.6%."""
    t0 = time.perf_counter()
    exps = {
        "baseline": _baseline(),
        "replication": run_faas_experiment("replication", _suite(),
                                           seed=SEEDS["replication"],
                                           start_time_s=9900.0),
        "lowmem": run_faas_experiment("lowmem", _suite(), memory_mb=1024,
                                      seed=SEEDS["lowmem"]),
        "single": run_faas_experiment("single", _suite(), n_calls=45,
                                      repeats_per_call=1, seed=SEEDS["single"]),
    }
    names = list(exps)
    poss = {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            cmp = compare_experiments(exps[a].changes, exps[b].changes)
            for bench, mag in cmp.possible_changes:
                poss[bench] = max(poss.get(bench, 0.0), mag)
    harness_us = (time.perf_counter() - t0) * 1e6
    vals = sorted(poss.values())
    rows = {
        "n_possible_changes": len(vals),
        "median_pct": round(float(np.median(vals)), 2) if vals else 0.0,
        "target_median_pct": 1.58,
        "p75_pct": round(float(np.percentile(vals, 75)), 2) if vals else 0.0,
        "target_p75_pct": 3.06,
        "max_pct": round(max(vals), 2) if vals else 0.0, "target_max_pct": 7.6,
    }
    return "possible_changes", harness_us, rows


def table_ci_repeats():
    """§6.2.7 Fig. 7: repeats needed until the ElastiBench CI size <= the
    original dataset's CI size; ~76% at 45 repeats, ~90% at 135."""
    t0 = time.perf_counter()
    big = run_faas_experiment("ci", _suite(), n_calls=50, repeats_per_call=4,
                              seed=SEEDS["ci"])
    orig = _original()
    steps = list(range(10, 136, 5))
    reached_45 = reached_135 = total = 0
    from repro_torch.core.stats import cis_overlap
    for name, c_big in big.changes.items():
        c_orig = orig.changes.get(name)
        if c_orig is None or not cis_overlap(c_big, c_orig):
            continue
        total += 1
        # rebuild the pair diffs in call order
        pairs = [p for p in big.report.pairs if p.benchmark == name]
        diffs = relative_diffs(np.array([p.v1_seconds for p in pairs]),
                               np.array([p.v2_seconds for p in pairs]))
        n = repeats_for_ci_parity(diffs, c_orig.ci_size, steps=steps)
        if n is not None and n <= 45:
            reached_45 += 1
        if n is not None and n <= 135:
            reached_135 += 1
    harness_us = (time.perf_counter() - t0) * 1e6
    rows = {
        "n_benchmarks": total,
        "parity_at_45_pct": round(reached_45 / max(total, 1) * 100, 1),
        "target_at_45_pct": 75.95,
        "parity_at_135_pct": round(reached_135 / max(total, 1) * 100, 1),
        "target_at_135_pct": 89.87,
    }
    return "ci_repeats", harness_us, rows


def table_time_cost():
    """Abstract headline: ~95% accurate detection in <=15 min at $0.49 vs
    ~4 h / $1.18 on VMs."""
    t0 = time.perf_counter()
    orig = _original()
    single = run_faas_experiment("single", _suite(), n_calls=45,
                                 repeats_per_call=1, seed=SEEDS["single"])
    cmp = compare_experiments(single.changes, orig.changes)
    harness_us = (time.perf_counter() - t0) * 1e6
    rows = {
        "faas_wall_min": round(single.report.wall_seconds / 60, 2),
        "target_faas_wall_min_max": 15.0,
        "faas_cost_usd": round(single.report.cost_dollars, 2),
        "target_faas_cost_usd": 0.49,
        "vm_wall_h": round(orig.report.wall_seconds / 3600, 2),
        "target_vm_wall_h": 4.0,
        "vm_cost_usd": round(orig.report.cost_dollars, 2),
        "target_vm_cost_usd": 1.18,
        "detection_agreement_pct": round(cmp.agreement * 100, 1),
        "target_detection_pct": 95.0,
        "speedup_x": round(orig.report.wall_seconds
                           / single.report.wall_seconds, 1),
    }
    return "time_cost_headline", harness_us, rows


ALL_TABLES = [table_aa, table_baseline, table_replication, table_lowmem,
              table_single_repeat, table_possible_changes, table_ci_repeats,
              table_time_cost]


def table_parallelism_curve():
    """Beyond-paper: the paper's parallelism<->cost<->wall-time tradeoff
    (§4) swept across fleet widths, demonstrating elastic scaling to
    1000-instance fleets."""
    t0 = time.perf_counter()
    from repro_torch.core import rmit
    from repro_torch.faas.platform import SimulatedFaaS
    suite = _suite()
    plan = rmit.make_plan(sorted(suite), n_calls=45, repeats_per_call=1,
                          seed=SEEDS["single"])
    rows = {}
    for par in (10, 50, 150, 500, 1000):
        rep = SimulatedFaaS(suite, seed=SEEDS["single"]).run_suite(
            plan, parallelism=par)
        rows[f"parallelism_{par}"] = {
            "wall_min": round(rep.wall_seconds / 60, 2),
            "cost_usd": round(rep.cost_dollars, 2),
            "cold_starts": rep.cold_starts,
        }
    harness_us = (time.perf_counter() - t0) * 1e6
    return "parallelism_curve", harness_us, rows


def table_memory_autotune():
    """Beyond-paper (§7.1 future work): per-benchmark function-memory
    right-sizing; cheaper suite runs with unchanged detections."""
    t0 = time.perf_counter()
    from repro_torch.core.autotune import autotune_memory
    res = autotune_memory(_suite(), seed=SEEDS["single"])
    harness_us = (time.perf_counter() - t0) * 1e6
    from collections import Counter
    dist = Counter(res.memory_map.values())
    rows = {
        "reference_cost_usd": round(res.reference_cost, 2),
        "tuned_cost_usd": round(res.tuned_cost, 2),
        "savings_pct": round(res.savings_pct, 1),
        "detections_consistent_pct": round(res.detections_consistent * 100, 1),
        "memory_distribution": {str(k): v for k, v in sorted(dist.items())},
    }
    return "memory_autotune", harness_us, rows


def table_adaptive_vs_fixed():
    """Beyond-paper (Rese et al. 2024 direction): fixed-RMIT vs adaptive
    CI-width stopping across three provider profiles.  The adaptive
    controller must match fixed detection accuracy (+-2 benchmarks on the
    106-benchmark suite) at a lower invocation count and billed cost."""
    t0 = time.perf_counter()
    suite = _suite()
    rows = {}
    for provider in ("lambda", "gcf", "azure"):
        fixed = run_faas_experiment(f"fixed_{provider}", suite,
                                    seed=SEEDS["baseline"],
                                    provider=provider)
        adap = run_adaptive_experiment(f"adaptive_{provider}", suite,
                                       seed=SEEDS["baseline"],
                                       provider=provider)
        only_f, only_a = detection_set_delta(fixed.changes, adap.changes)
        acc_f = detection_accuracy(suite, fixed.changes)
        acc_a = detection_accuracy(suite, adap.changes)
        s = adap.adaptive
        rows[provider] = {
            "fixed_invocations": len(fixed.report.billed_seconds),
            "adaptive_invocations": adap.invocations_used,
            "invocations_saved_pct": round(
                (1 - adap.invocations_used
                 / max(len(fixed.report.billed_seconds), 1)) * 100, 1),
            "fixed_cost_usd": round(fixed.report.cost_dollars, 3),
            "adaptive_cost_usd": round(adap.report.cost_dollars, 3),
            "cost_saved_pct": round((1 - adap.report.cost_dollars
                                     / fixed.report.cost_dollars) * 100, 1),
            "fixed_wall_min": round(fixed.report.wall_seconds / 60, 2),
            "adaptive_wall_min": round(adap.report.wall_seconds / 60, 2),
            "fixed_detected": fixed.n_changed,
            "adaptive_detected": adap.n_changed,
            "detection_set_delta": len(only_f) + len(only_a),
            "accuracy_fixed": acc_f, "accuracy_adaptive": acc_a,
            "accuracy_diff": acc_a - acc_f, "target_accuracy_diff_min": -2,
            "stopped_early": len(s.stopped_early),
            "gave_up": len(s.gave_up),
            "topped_up_invocations": s.invocations_added,
        }
    harness_us = (time.perf_counter() - t0) * 1e6
    return "adaptive_vs_fixed", harness_us, rows


def table_pipeline_vs_full():
    """Beyond-paper (Japke et al. 2025 direction): the continuous-
    benchmarking pipeline over a 20-commit stream, full-suite vs selective
    vs selective+cached, across all three provider profiles.  Selection +
    caching must cut invocations and billed cost by >=30% while keeping
    mean per-commit detection accuracy within +-2 benchmarks, and the
    history changepoint detector must flag the stream's multi-commit drift
    that no single pairwise comparison shows in full."""
    t0 = time.perf_counter()
    rows = {}
    for provider in ("lambda", "gcf", "azure"):
        res = run_pipeline_experiment(provider, n_commits=20,
                                      seed=SEEDS["pipeline"])
        full = res.report("full")
        sel = res.report("selective")
        cached = res.report("selective_cached")
        drift_ev = res.drift_event("selective_cached")
        rows[provider] = {
            "full_invocations": full.total_invocations,
            "selective_invocations": sel.total_invocations,
            "cached_invocations": cached.total_invocations,
            "invocations_saved_pct": round(
                (1 - cached.total_invocations
                 / max(full.total_invocations, 1)) * 100, 1),
            "target_saved_pct_min": 30.0,
            "full_cost_usd": round(full.total_cost, 2),
            "cached_cost_usd": round(cached.total_cost, 2),
            "cost_saved_pct": round((1 - cached.total_cost
                                     / full.total_cost) * 100, 1),
            "full_wall_min": round(full.total_wall_seconds / 60, 1),
            "cached_wall_min": round(cached.total_wall_seconds / 60, 1),
            "cache_hits": cached.cache_hits,
            "accuracy_full": round(res.accuracy["full"], 1),
            "accuracy_selective": round(res.accuracy["selective"], 1),
            "accuracy_cached": round(res.accuracy["selective_cached"], 1),
            "accuracy_delta": round(res.accuracy["selective_cached"]
                                    - res.accuracy["full"], 1),
            "target_accuracy_delta_min": -2.0,
            "drift_truth_pct": round(res.drift.total_pct, 1),
            "drift_window": f"{res.drift.start}..{res.drift.end}",
            "drift_detected": drift_ev is not None,
            "drift_detected_pct": round(drift_ev.cumulative_pct, 1)
            if drift_ev else 0.0,
            "drift_z": round(drift_ev.score, 1) if drift_ev else 0.0,
            "drift_single_pair_flags": len(
                res.drift_single_pair_flags("selective_cached")),
            "drift_window_commits": res.drift.length,
        }
    harness_us = (time.perf_counter() - t0) * 1e6
    return "pipeline_vs_full", harness_us, rows


def table_service_pareto():
    """Beyond-paper (benchmarking-as-a-service): the deadline/cost planner
    sweeps provider x memory x fleet x repeat-plan candidates, and the
    executed (cost, makespan) frontier must contain a planner-chosen FaaS
    configuration that meets a 15-minute virtual-time deadline at strictly
    lower billed cost than the measured VM baseline — the paper's headline
    corner found by search instead of by hand."""
    t0 = time.perf_counter()
    res = run_service_pareto_experiment(
        deadline_s=900.0, seed=SEEDS["service"], suite_seed=SEEDS["suite"])
    harness_us = (time.perf_counter() - t0) * 1e6
    rows = {
        "deadline_min": 15.0,
        "candidates": res.n_candidates,
        "chosen": res.chosen.label,
        "chosen_wall_min": round(res.chosen.actual_wall_s / 60, 2),
        "chosen_cost_usd": round(res.chosen.actual_cost_usd, 3),
        "chosen_predicted_wall_min": round(
            res.chosen.predicted_wall_s / 60, 2),
        "chosen_predicted_cost_usd": round(
            res.chosen.predicted_cost_usd, 3),
        "vm_wall_h": round(res.vm_wall_s / 3600, 2),
        "vm_cost_usd": round(res.vm_cost_usd, 2),
        "meets_deadline": res.meets_deadline,
        "cheaper_than_vm": res.cheaper_than_vm,
        "speedup_vs_vm_x": round(res.vm_wall_s / res.chosen.actual_wall_s,
                                 1),
        "cost_saving_vs_vm_pct": round(
            (1 - res.chosen.actual_cost_usd / res.vm_cost_usd) * 100, 1),
        "accuracy_chosen": res.chosen_accuracy,
        "accuracy_vm": res.vm_accuracy,
        "frontier": {
            r.label: {"wall_min": round(r.actual_wall_s / 60, 2),
                      "cost_usd": round(r.actual_cost_usd, 3)}
            for r in res.rows},
    }
    return "service_pareto", harness_us, rows


def table_multi_tenant_throughput():
    """Beyond-paper (benchmarking-as-a-service): N=1..32 concurrent
    commit-stream tenants sharing one service fleet.  The weighted-fair
    scheduler must keep Jain fairness high and p95 job latency bounded as
    concurrency scales, with deterministic (seed-reproducible) schedules."""
    t0 = time.perf_counter()
    rows = {}
    for n in (1, 2, 4, 8, 16, 32):
        r = run_multi_tenant_experiment(n, provider="lambda",
                                        seed=SEEDS["tenants"])
        rows[f"tenants_{n:02d}"] = {
            "jobs": r.jobs,
            "makespan_min": round(r.makespan_s / 60, 2),
            "p95_latency_min": round(r.p95_latency_s / 60, 2),
            "mean_latency_min": round(r.mean_latency_s / 60, 2),
            "fairness_jain": round(r.fairness, 3),
            "cost_usd": round(r.total_cost_usd, 3),
            "invocations": r.total_invocations,
            "cold_starts": r.cold_starts,
            "flagged": r.flagged,
            "digest": r.digest,
        }
    harness_us = (time.perf_counter() - t0) * 1e6
    return "multi_tenant_throughput", harness_us, rows


def table_chaos_robustness(*, quick: bool = False):
    """Beyond-paper (chaos hardening): fault intensity x provider sweep on
    the chaos-wrapped platform models (faas/chaos.py) — lost invocations,
    timeout storms, duplicate deliveries, zombie warm instances, billing
    anomalies, plus non-stationary regimes (diurnal drift, regional
    heterogeneity, cold-start spikes, noisy-neighbor bursts).  The same
    chaos-perturbed pairs are analyzed by the naive CI path and by the
    outlier-robust (MAD-fence trimmed) path: robust detection accuracy
    must stay >= 90% at moderate intensity (1.0) while the naive path
    measurably degrades there and collapses further at heavy intensity
    (2.0)."""
    from repro_torch.core.experiment import run_chaos_robustness_experiment
    t0 = time.perf_counter()
    providers = ("lambda",) if quick else ("lambda", "gcf", "azure")
    intensities = (0.0, 1.0) if quick else (0.0, 1.0, 2.0)
    seeds_per_cell = 2 if quick else 3
    cells = run_chaos_robustness_experiment(
        providers=providers, intensities=intensities,
        seed=SEEDS["chaos"], suite_seed=SEEDS["suite"],
        seeds_per_cell=seeds_per_cell)
    harness_us = (time.perf_counter() - t0) * 1e6
    rows = {"target_robust_pct_min": 90.0}
    for c in cells:
        rows[f"{c.provider}_i{c.intensity:g}"] = {
            "accuracy_naive": round(c.accuracy_naive, 1),
            "accuracy_robust": round(c.accuracy_robust, 1),
            "accuracy_naive_pct": round(c.accuracy_naive_pct, 1),
            "accuracy_robust_pct": round(c.accuracy_robust_pct, 1),
            "executed": round(c.n_executed, 1),
            "ci_width_naive": round(c.ci_width_naive, 2),
            "ci_width_robust": round(c.ci_width_robust, 2),
            "retries": c.retries, "lost": c.lost,
            "duplicates_dropped": c.duplicates_dropped,
            "timeouts": c.timeouts,
            "cost_usd": round(c.cost_usd, 2),
            "wall_min": round(c.wall_s / 60, 2),
        }
    return "chaos_robustness", harness_us, rows


def table_engine_scaling():
    """Tentpole (planet-scale engine core): the vectorized
    structure-of-arrays engine vs the scalar reference event loop on the
    engine_bench synthetic tenant.  Small sizes are measured live with a
    bit-exactness check; the committed full sweep (BENCH_engine.json,
    N up to 10^6) is merged in as ``baseline_*`` rows."""
    t0 = time.perf_counter()
    import json

    from repro_torch.benchmarks import engine_bench as eb
    suite = eb.synthetic_suite(seed=BASE_SEED)
    rows = {}
    for n in (1_000, 10_000):
        plan = eb.make_size_plan(suite, n, seed=BASE_SEED)
        n_inv = len(plan.invocations)
        fast_rep, fast_s = eb._run("fast", suite, plan, BASE_SEED, reps=3)
        ref_rep, ref_s = eb._run("reference", suite, plan, BASE_SEED,
                                 reps=2)
        if eb._digest(fast_rep) != eb._digest(ref_rep):
            raise AssertionError(f"engine conformance FAILED at N={n_inv}")
        rows[f"live_n_{n_inv}"] = {
            "vec_us_per_inv": round(fast_s / n_inv * 1e6, 2),
            "scalar_us_per_inv": round(ref_s / n_inv * 1e6, 2),
            "speedup": round(ref_s / fast_s, 1),
            "bit_exact": True,
        }
    baseline = os.path.join(REPO_ROOT, "BENCH_engine.json")
    if os.path.exists(baseline):
        with open(baseline) as f:
            for r in json.load(f)["sizes"]:
                rows[f"baseline_n_{r['n_invocations']}"] = {
                    "vec_s": r["vec_s"],
                    "vec_us_per_inv": r["vec_us_per_inv"],
                    "speedup": r.get("speedup"),
                    "bit_exact": r.get("conformant", False),
                }
    harness_us = (time.perf_counter() - t0) * 1e6
    return "engine_scaling", harness_us, rows


ALL_TABLES.extend([table_parallelism_curve, table_memory_autotune,
                   table_adaptive_vs_fixed, table_pipeline_vs_full,
                   table_service_pareto, table_multi_tenant_throughput,
                   table_chaos_robustness, table_engine_scaling])
