"""Paper §6 experiment definitions.

The SUT of the paper's evaluation is VictoriaMetrics' microbenchmark suite
(106 benchmarks, two commits).  We reproduce the evaluation *mechanism* with
a deterministic synthetic suite whose ground-truth effect distribution
matches the paper's reported statistics (§6.2.2: median detected change
4.71%, max 116%; §6.2.1: 90/106 executable on FaaS; a known-unreliable
benchmark family like BenchmarkAddMulti), then run the same six experiments:

  A/A, baseline, replication, lower-memory, single-repeat,
  repeats-for-consistent-CI-size  (+ time/cost accounting).

The FaaS runs must *agree* with the VM-simulated "original dataset" the way
the paper's runs agreed with [23] — that is the reproduction claim.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import rmit, stats
from repro_torch.core.controller import (AdaptiveConfig, AdaptiveController,
                                   AdaptiveSummary)
from repro_torch.core.results import analyze
from repro_torch.faas.backends import SimFaaSBackend
from repro_torch.faas.engine import EngineConfig, EngineReport, ExecutionEngine
from repro_torch.faas.platform import (SimReport, SimulatedVM, SimWorkload,
                                 VMPlatformConfig, make_provider_backend)

N_BENCHMARKS = 106


def victoriametrics_like_suite(seed: int = 42) -> Dict[str, SimWorkload]:
    """106 synthetic microbenchmarks with a paper-shaped ground truth:
    16 fail on FaaS (restricted FS / >20 s runs) -> 90 executed (§6.2.1);
    effect CDF giving a median detected change of ~4-5% and max ~116%
    (§6.2.2); three BenchmarkAddMulti-like unstable configurations."""
    rng = np.random.default_rng(seed)
    suite: Dict[str, SimWorkload] = {}
    for i in range(N_BENCHMARKS):
        base = float(np.exp(rng.uniform(np.log(0.3), np.log(6.0))))
        r = rng.random()
        if r < 0.45:
            effect = 0.0                                   # unchanged code path
        elif r < 0.57:
            effect = float(rng.choice([-1, 1])) * float(rng.uniform(0.1, 0.6))
        elif r < 0.96:
            effect = float(rng.choice([-1, 1]) * np.exp(
                rng.uniform(np.log(3), np.log(20))))       # solid changes
        else:
            effect = float(rng.uniform(60, 116))           # big regressions
        fs_write = i % 7 == 3                              # 15 restricted-FS
        if i == 99:
            base = 30.0                                    # always beyond 20s
        # magnitude depends on environment/toolchain (paper §6.2.2 explains
        # the low two-sided coverage this way)
        vm_scale = float(rng.uniform(0.8, 1.25))
        unstable = 6.0 if i in (17, 18, 19) else 0.0      # BenchmarkAddMulti-like
        if unstable:
            # the benchmark itself changed between commits (eb103e15): the
            # two environments see opposite-direction "changes"
            effect, vm_scale = 6.0, -1.7
        suite[f"Benchmark{i:03d}"] = SimWorkload(
            name=f"Benchmark{i:03d}", base_seconds=base, effect_pct=effect,
            run_sigma=float(rng.uniform(0.02, 0.05)), fs_write=fs_write,
            setup_seconds=float(rng.uniform(8.0, 16.0)), unstable_pct=unstable,
            vm_effect_scale=vm_scale)
    return suite


def aa_suite(suite: Dict[str, SimWorkload]) -> Dict[str, SimWorkload]:
    """A/A: both versions are v1 (effect 0 everywhere)."""
    return {k: replace(w, effect_pct=0.0) for k, w in suite.items()}


@dataclass
class ExperimentResult:
    name: str
    report: SimReport
    changes: Dict[str, stats.ChangeResult]

    @property
    def n_executed(self) -> int:
        return len(self.report.executed_benchmarks)

    @property
    def n_changed(self) -> int:
        return sum(1 for c in self.changes.values() if c.changed)


def _make_backend(suite: Dict[str, SimWorkload], provider: str,
                  memory_mb: int, seed: int,
                  start_time_s: float) -> SimFaaSBackend:
    # the lambda path replays the original SimulatedFaaS bit-for-bit
    return make_provider_backend(suite, provider, memory_mb=memory_mb,
                                 seed=seed, start_time_s=start_time_s)


def run_faas_experiment(name: str, suite: Dict[str, SimWorkload], *,
                        n_calls: int = 15, repeats_per_call: int = 3,
                        parallelism: int = 150, memory_mb: int = 2048,
                        seed: int = 0, start_time_s: float = 0.0,
                        min_results: int = 10,
                        provider: str = "lambda",
                        max_retries: int = 0,
                        engine: Optional[str] = None) -> ExperimentResult:
    from repro_torch.faas.engine_vec import make_engine
    plan = rmit.make_plan(sorted(suite), n_calls=n_calls,
                          repeats_per_call=repeats_per_call, seed=seed)
    backend = _make_backend(suite, provider, memory_mb, seed, start_time_s)
    eng = make_engine(backend, EngineConfig(parallelism=parallelism,
                                            max_retries=max_retries),
                      engine=engine)
    report = SimReport.from_engine(eng.run(plan))
    changes = analyze(report.pairs, seed=seed, min_results=min_results)
    return ExperimentResult(name=name, report=report, changes=changes)


@dataclass
class AdaptiveExperimentResult(ExperimentResult):
    engine_report: Optional[EngineReport] = None   # skipped/topped-up detail
    adaptive: Optional[AdaptiveSummary] = None

    @property
    def invocations_used(self) -> int:
        return len(self.report.billed_seconds)


def run_adaptive_experiment(name: str, suite: Dict[str, SimWorkload], *,
                            n_calls: int = 15, repeats_per_call: int = 3,
                            parallelism: int = 150, memory_mb: int = 2048,
                            seed: int = 0, start_time_s: float = 0.0,
                            min_results: int = 10,
                            provider: str = "lambda",
                            max_retries: int = 0,
                            adaptive_cfg: Optional[AdaptiveConfig] = None
                            ) -> AdaptiveExperimentResult:
    """Same plan as `run_faas_experiment`, but with the AdaptiveController
    attached: benchmarks stop once their CI is tight and the saved budget
    tops up noisy ones."""
    plan = rmit.make_plan(sorted(suite), n_calls=n_calls,
                          repeats_per_call=repeats_per_call, seed=seed)
    backend = _make_backend(suite, provider, memory_mb, seed, start_time_s)
    engine = ExecutionEngine(backend, EngineConfig(parallelism=parallelism,
                                                   max_retries=max_retries))
    # the controller's interim CIs must be computed with the same seed and
    # min_results as the final analyze() below, or an early-stop decision
    # could be contradicted by the final analysis of the same pairs
    if adaptive_cfg is None:
        adaptive_cfg = AdaptiveConfig(min_results=min_results, seed=seed)
    else:
        adaptive_cfg = replace(adaptive_cfg, min_results=min_results,
                               seed=seed)
    controller = AdaptiveController(plan, adaptive_cfg)
    engine_report = engine.run(plan, observer=controller)
    report = SimReport.from_engine(engine_report)
    # the controller's streaming analyzer IS the final analysis: it holds
    # the pairs in the completion order its stop decisions were based on
    # (bootstrap CIs are order-sensitive), so results can never contradict
    # a stop decision
    changes = controller.analyzer.analyze()
    return AdaptiveExperimentResult(name=name, report=report, changes=changes,
                                    engine_report=engine_report,
                                    adaptive=controller.summary())


def detection_accuracy(suite: Dict[str, SimWorkload],
                       changes: Dict[str, stats.ChangeResult], *,
                       floor_pct: float = 1.0) -> int:
    """Benchmarks classified correctly against the synthetic ground truth:
    a true effect >= `floor_pct` must be detected with the right sign; a
    smaller/zero effect must not be flagged.  (Effects below the floor are
    beneath the suite's detection power at these noise levels — the paper
    §6.2.6 similarly treats small disagreements as 'possible changes'.)"""
    ok = 0
    for name, wl in suite.items():
        should = abs(wl.effect_pct) >= floor_pct
        c = changes.get(name)
        detected = c is not None and c.changed
        if should:
            ok += int(detected and c.direction == (1 if wl.effect_pct > 0
                                                   else -1))
        else:
            ok += int(not detected)
    return ok


def run_vm_experiment(name: str, suite: Dict[str, SimWorkload], *,
                      n_trials: int = 45, seed: int = 1,
                      min_results: int = 10) -> ExperimentResult:
    """The 'original dataset': sequential VM-based RMIT (paper [23])."""
    plan = rmit.make_plan(sorted(suite), n_calls=n_trials, repeats_per_call=1,
                          seed=seed)
    platform = SimulatedVM(suite, VMPlatformConfig(), seed=seed)
    report = platform.run_suite(plan)
    changes = analyze(report.pairs, seed=seed, min_results=min_results)
    return ExperimentResult(name=name, report=report, changes=changes)


# ------------------------------------------------------- chaos robustness
@dataclass
class ChaosExperimentResult:
    """One suite run on a chaos-perturbed platform, analyzed twice over
    the *same* pairs: the naive CI path and the outlier-robust path."""
    name: str
    report: SimReport
    engine_report: EngineReport
    changes_naive: Dict[str, stats.ChangeResult]
    changes_robust: Dict[str, stats.ChangeResult]
    chaos_stats: Dict[str, int]


def run_chaos_experiment(name: str, suite: Dict[str, SimWorkload], *,
                         provider: str = "lambda", chaos=None,
                         robust: str = "trim", robust_k: float = 3.5,
                         n_calls: int = 12,
                         repeats_per_call: int = 3, parallelism: int = 150,
                         memory_mb: int = 2048, seed: int = 0,
                         start_time_s: float = 0.0, min_results: int = 10,
                         max_retries: int = 1,
                         engine: Optional[str] = None
                         ) -> ChaosExperimentResult:
    """`run_faas_experiment` on a chaos-wrapped platform model.

    The engine runs with retries enabled (losses, zombie hits, and storm
    timeouts are transient platform failures) and the identical result
    pairs are analyzed by both the naive and the robust CI path — any
    accuracy gap between the two is attributable to the statistics, not
    to the run."""
    from repro_torch.faas.chaos import ChaosBackend
    from repro_torch.faas.engine_vec import make_engine
    plan = rmit.make_plan(sorted(suite), n_calls=n_calls,
                          repeats_per_call=repeats_per_call, seed=seed)
    backend = _make_backend(suite, provider, memory_mb, seed, start_time_s)
    chaos_stats: Dict[str, int] = {}
    if chaos is not None:
        backend = ChaosBackend(backend, chaos)
    eng = make_engine(backend, EngineConfig(parallelism=parallelism,
                                            max_retries=max_retries),
                      engine=engine)
    engine_report = eng.run(plan)
    if chaos is not None:
        chaos_stats = dict(backend.stats)
    report = SimReport.from_engine(engine_report)
    naive = analyze(report.pairs, seed=seed, min_results=min_results)
    robust_changes = analyze(report.pairs, seed=seed,
                             min_results=min_results, robust=robust,
                             robust_k=robust_k)
    return ChaosExperimentResult(
        name=name, report=report, engine_report=engine_report,
        changes_naive=naive, changes_robust=robust_changes,
        chaos_stats=chaos_stats)


@dataclass
class ChaosCell:
    """One (provider, intensity) cell of the chaos_robustness sweep,
    averaged over `n_seeds` independently seeded runs (accuracy is a
    small-count statistic — 106 benchmarks — so single-run cells are
    +-2 benchmarks noisy; the mean over a few seeds is stable)."""
    provider: str
    intensity: float
    n_seeds: int
    accuracy_naive: float               # mean correct / 106
    accuracy_robust: float
    accuracy_naive_pct: float
    accuracy_robust_pct: float
    n_executed: float
    ci_width_naive: float               # median CI width, mean over seeds
    ci_width_robust: float
    retries: int                        # totals over all seeds
    lost: int
    duplicates_dropped: int
    timeouts: int
    cost_usd: float
    wall_s: float                       # mean makespan per run
    chaos_stats: Dict[str, int]         # totals over all seeds


def _median_ci_width(changes: Dict[str, stats.ChangeResult]) -> float:
    widths = [c.ci_size for c in changes.values()]
    return float(np.median(widths)) if widths else float("nan")


def run_chaos_robustness_experiment(*, providers=("lambda", "gcf", "azure"),
                                    intensities=(0.0, 1.0, 2.0),
                                    seed: int = 0, suite_seed: int = 42,
                                    n_calls: int = 12, seeds_per_cell: int = 3,
                                    robust: str = "trim",
                                    robust_k: float = 3.5,
                                    max_retries: int = 1
                                    ) -> List[ChaosCell]:
    """Sweep fault intensity x provider and score detection accuracy of
    the naive vs the robust statistics path against the suite's ground
    truth — both paths analyze the *identical* chaos-perturbed pairs, so
    the gap is attributable to the statistics alone.

    Intensity 1 is the `moderate_chaos` scenario; 0 is the calm platform
    (and, through the zero-intensity identity, a live conformance check
    that the wrapper changes nothing); 2 doubles every fault rate and
    regime amplitude.  Each cell averages `seeds_per_cell` runs."""
    from repro_torch.faas.chaos import moderate_chaos
    suite = victoriametrics_like_suite(seed=suite_seed)
    cells: List[ChaosCell] = []
    for provider in providers:
        for intensity in intensities:
            acc_n: List[int] = []
            acc_r: List[int] = []
            execd: List[int] = []
            wn: List[float] = []
            wr: List[float] = []
            walls: List[float] = []
            retries = lost = dups = timeouts = 0
            cost = 0.0
            agg: Dict[str, int] = {}
            for s in range(seeds_per_cell):
                run_seed = seed + 101 * s
                chaos = moderate_chaos(seed=run_seed).scaled(intensity)
                res = run_chaos_experiment(
                    f"chaos_{provider}_{intensity:g}_{run_seed}", suite,
                    provider=provider, chaos=chaos, robust=robust,
                    robust_k=robust_k, n_calls=n_calls, seed=run_seed,
                    max_retries=max_retries)
                rep = res.engine_report
                acc_n.append(detection_accuracy(suite, res.changes_naive))
                acc_r.append(detection_accuracy(suite, res.changes_robust))
                execd.append(len(rep.executed_benchmarks))
                wn.append(_median_ci_width(res.changes_naive))
                wr.append(_median_ci_width(res.changes_robust))
                walls.append(rep.wall_seconds)
                retries += rep.retries
                lost += rep.lost
                dups += rep.duplicates_dropped
                timeouts += rep.timeouts
                cost += rep.cost_dollars
                for k, v in res.chaos_stats.items():
                    agg[k] = agg.get(k, 0) + v
            n_bench = len(suite)
            mean_n = float(np.mean(acc_n))
            mean_r = float(np.mean(acc_r))
            cells.append(ChaosCell(
                provider=provider, intensity=float(intensity),
                n_seeds=seeds_per_cell,
                accuracy_naive=mean_n, accuracy_robust=mean_r,
                accuracy_naive_pct=mean_n / n_bench * 100.0,
                accuracy_robust_pct=mean_r / n_bench * 100.0,
                n_executed=float(np.mean(execd)),
                ci_width_naive=float(np.mean(wn)),
                ci_width_robust=float(np.mean(wr)),
                retries=retries, lost=lost, duplicates_dropped=dups,
                timeouts=timeouts, cost_usd=cost,
                wall_s=float(np.mean(walls)), chaos_stats=agg))
    return cells


# ----------------------------------------------- continuous benchmarking (cb)
@dataclass
class PipelineExperimentResult:
    """`pipeline_vs_full`: one provider's commit stream evaluated in every
    pipeline mode (full / selective / selective_cached)."""
    provider: str
    commits: list                       # List[repro_torch.cb.Commit]
    drift: object                       # repro_torch.cb.DriftSpec ground truth
    reports: Dict[str, object]          # mode -> repro_torch.cb.PipelineReport
    accuracy: Dict[str, float]          # mode -> mean per-commit accuracy

    def report(self, mode: str):
        return self.reports[mode]

    def drift_event(self, mode: str):
        """The detector's event for the drifting benchmark, if any."""
        return next((e for e in self.reports[mode].events
                     if e.benchmark == self.drift.benchmark), None)

    def drift_single_pair_flags(self, mode: str) -> List[int]:
        """Commits inside the drift window where pairwise analysis alone
        flagged the drifting benchmark."""
        window = set(self.drift.commits())
        return [c.commit_index for c in self.reports[mode].commits
                if self.drift.benchmark in c.flagged
                and c.commit_index in window]


def pipeline_detection_accuracy(commits, report, measurable: List[str], *,
                                floor_pct: float = 2.0) -> float:
    """Mean per-commit count of correctly classified benchmarks against the
    stream's ground truth (the commit-stream analogue of
    `detection_accuracy`): a true step >= floor_pct must be detected with
    the right sign, anything smaller must not be flagged.  Skipped/cached
    benchmarks count as not-flagged — for an unchanged fingerprint that is
    the correct call by construction."""
    runs = {c.commit_id: c for c in report.commits}
    per_commit = []
    for commit in commits[1:]:
        run = runs[commit.commit_id]
        ok = 0
        for b in measurable:
            truth = commit.step_effect(b)
            should = abs(truth) >= floor_pct
            c = run.changes.get(b)
            detected = c is not None and c.changed
            if should:
                ok += int(detected and c.direction == (1 if truth > 0
                                                       else -1))
            else:
                ok += int(not detected)
        per_commit.append(ok)
    return float(np.mean(per_commit))


# --------------------------------------------- benchmarking-as-a-service
@dataclass
class ParetoRow:
    """One executed candidate of the service Pareto sweep."""
    label: str
    provider: str
    predicted_wall_s: float
    predicted_cost_usd: float
    actual_wall_s: float
    actual_cost_usd: float
    executed: int
    chosen: bool = False


@dataclass
class ServiceParetoResult:
    """`service_pareto`: planner candidates vs the measured VM baseline.

    The acceptance claim of the experiment: the planner-chosen FaaS
    configuration actually meets the virtual-time deadline at strictly
    lower billed cost than the VM baseline — the paper's headline corner
    (<=15 min / $0.49 FaaS vs ~4 h / $1.18 VM) found by search instead of
    by hand."""
    deadline_s: float
    n_candidates: int
    rows: List[ParetoRow]               # executed frontier, cheapest first
    chosen: ParetoRow
    vm_wall_s: float
    vm_cost_usd: float
    chosen_accuracy: int                # detection accuracy of chosen run
    vm_accuracy: int

    @property
    def meets_deadline(self) -> bool:
        return self.chosen.actual_wall_s <= self.deadline_s

    @property
    def cheaper_than_vm(self) -> bool:
        return self.chosen.actual_cost_usd < self.vm_cost_usd


def _execute_candidate(cand, suite: Dict[str, SimWorkload], *,
                       seed: int) -> ExperimentResult:
    """Run one planner candidate on the platform model it priced."""
    from repro_torch.faas.backends import PROVIDER_PROFILES
    from repro_torch.service.planner import VM_PROVIDER
    if cand.provider == VM_PROVIDER:
        plan = rmit.make_plan(sorted(suite), n_calls=cand.n_calls,
                              repeats_per_call=cand.repeats_per_call,
                              seed=seed)
        platform = SimulatedVM(suite, VMPlatformConfig(
            n_vms=cand.parallelism), seed=seed)
        report = platform.run_suite(plan)
    else:
        profile = PROVIDER_PROFILES[cand.provider]
        backend = SimFaaSBackend(suite, profile,
                                 memory_mb=cand.memory_mb or 2048,
                                 memory_map=cand.memory_map_dict(),
                                 seed=seed)
        plan = rmit.make_plan(sorted(suite), n_calls=cand.n_calls,
                              repeats_per_call=cand.repeats_per_call,
                              seed=seed)
        from repro_torch.faas.engine_vec import make_engine
        eng = make_engine(backend,
                          EngineConfig(parallelism=cand.parallelism))
        report = SimReport.from_engine(eng.run(plan))
    changes = analyze(report.pairs, seed=seed)
    return ExperimentResult(name=cand.label, report=report, changes=changes)


def run_service_pareto_experiment(*, deadline_s: float = 900.0,
                                  seed: int = 0, suite_seed: int = 42,
                                  max_rows: int = 10
                                  ) -> ServiceParetoResult:
    """Sweep the planner's candidate space, execute the (cost, makespan)
    frontier plus the chosen plan, and compare against the measured VM
    baseline."""
    from repro_torch.service.planner import DeadlineCostPlanner, pareto_frontier
    suite = victoriametrics_like_suite(seed=suite_seed)
    planner = DeadlineCostPlanner()
    cands = planner.candidates(suite, seed=seed)
    chosen_cand = planner.choose(cands, deadline_s=deadline_s)
    frontier = pareto_frontier(cands)
    to_run = [c for c in frontier if c.provider != "vm"][:max_rows]
    if chosen_cand not in to_run:
        to_run.append(chosen_cand)

    vm = run_vm_experiment("vm_baseline", suite, seed=seed + 1)
    rows: List[ParetoRow] = []
    chosen_row = None
    chosen_res = None
    for cand in to_run:
        res = _execute_candidate(cand, suite, seed=seed)
        row = ParetoRow(
            label=cand.label, provider=cand.provider,
            predicted_wall_s=cand.predicted_wall_s,
            predicted_cost_usd=cand.predicted_cost_usd,
            actual_wall_s=res.report.wall_seconds,
            actual_cost_usd=res.report.cost_dollars,
            executed=res.n_executed, chosen=cand == chosen_cand)
        rows.append(row)
        if row.chosen:
            chosen_row = row
            chosen_res = res
    rows.sort(key=lambda r: (r.actual_cost_usd, r.actual_wall_s))
    return ServiceParetoResult(
        deadline_s=deadline_s, n_candidates=len(cands), rows=rows,
        chosen=chosen_row, vm_wall_s=vm.report.wall_seconds,
        vm_cost_usd=vm.report.cost_dollars,
        chosen_accuracy=detection_accuracy(suite, chosen_res.changes),
        vm_accuracy=detection_accuracy(suite, vm.changes))


@dataclass
class MultiTenantResult:
    """`multi_tenant_throughput` at one concurrency level: N tenants each
    running a commit-stream through one shared service."""
    n_tenants: int
    provider: str
    jobs: int
    makespan_s: float
    p95_latency_s: float
    mean_latency_s: float
    fairness: float                     # Jain over per-tenant billed s
    total_cost_usd: float
    total_invocations: int
    cold_starts: int
    flagged: int                        # pairwise detections across tenants
    digest: str                         # deterministic schedule digest


def run_multi_tenant_experiment(n_tenants: int, *,
                                provider: str = "lambda",
                                n_commits: int = 4, n_calls: int = 10,
                                repeats_per_call: int = 3,
                                parallelism: int = 150,
                                seed: int = 0,
                                chaos=None,
                                engine=None) -> MultiTenantResult:
    """N concurrent commit-stream tenants sharing one service fleet.

    Every tenant owns an independent synthetic commit stream (distinct
    seed) over the shared suite shape and submits each commit as a job to
    the same `BenchmarkService`; the weighted-fair queue interleaves the
    streams across the fleet.  Deterministic: the returned digest is a
    pure function of (n_tenants, provider, knobs, seed)."""
    from repro_torch.cb import (Pipeline, PipelineConfig, StreamConfig,
                          SyntheticSuite, synthetic_stream)
    from repro_torch.service import BenchmarkService, ServiceConfig
    base = SyntheticSuite()
    service = BenchmarkService(ServiceConfig(parallelism=parallelism,
                                             seed=seed, chaos=chaos,
                                             engine=engine))
    pipelines = []
    for t in range(n_tenants):
        stream_seed = seed + 7919 * (t + 1)
        commits, _ = synthetic_stream(
            base.benchmark_names(),
            StreamConfig(n_commits=n_commits, seed=stream_seed),
            effectable=base.measurable_names(),
            drift_candidates=base.quiet_names())
        pipe = Pipeline(SyntheticSuite(base.workloads), PipelineConfig(
            provider=provider, mode="selective", n_calls=n_calls,
            repeats_per_call=repeats_per_call, parallelism=parallelism,
            seed=stream_seed))
        pending = pipe.submit_stream(commits, service,
                                     tenant=f"tenant{t:02d}")
        pipelines.append((pipe, pending))
    report = service.run()
    flagged = 0
    for pipe, pending in pipelines:
        flagged += pipe.collect_service(pending).total_flagged
    lats = report.latencies_s()
    return MultiTenantResult(
        n_tenants=n_tenants, provider=provider, jobs=len(report.results),
        makespan_s=report.makespan_s,
        p95_latency_s=report.p95_latency_s(),
        mean_latency_s=float(np.mean(lats)) if lats else 0.0,
        fairness=report.fairness,
        total_cost_usd=report.total_cost_usd,
        total_invocations=report.total_invocations,
        cold_starts=report.cold_starts, flagged=flagged,
        digest=report.digest())


def run_pipeline_experiment(provider: str = "lambda", *, n_commits: int = 20,
                            seed: int = 0, n_calls: int = 15,
                            repeats_per_call: int = 3,
                            parallelism: int = 150,
                            max_staleness: int = 5,
                            modes: tuple = ("full", "selective",
                                            "selective_cached"),
                            floor_pct: float = 2.0
                            ) -> PipelineExperimentResult:
    """One synthetic commit stream evaluated per pipeline mode on one
    provider profile; every mode sees the identical stream (same ground
    truth, same drift) so invocation/cost/accuracy deltas are attributable
    to selection and caching alone."""
    from repro_torch.cb import (Pipeline, PipelineConfig, StreamConfig,
                          SyntheticSuite, synthetic_stream)
    suite = SyntheticSuite()
    commits, drift = synthetic_stream(
        suite.benchmark_names(), StreamConfig(n_commits=n_commits, seed=seed),
        effectable=suite.measurable_names(),
        drift_candidates=suite.quiet_names())
    measurable = suite.measurable_names()
    reports, accuracy = {}, {}
    for mode in modes:
        cfg = PipelineConfig(provider=provider, mode=mode, n_calls=n_calls,
                             repeats_per_call=repeats_per_call,
                             parallelism=parallelism, seed=seed,
                             max_staleness=max_staleness)
        rep = Pipeline(SyntheticSuite(suite.workloads), cfg).run_stream(
            commits)
        reports[mode] = rep
        accuracy[mode] = pipeline_detection_accuracy(commits, rep, measurable,
                                                     floor_pct=floor_pct)
    return PipelineExperimentResult(provider=provider, commits=commits,
                                    drift=drift, reports=reports,
                                    accuracy=accuracy)
