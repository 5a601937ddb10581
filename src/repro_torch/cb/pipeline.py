"""Continuous-benchmarking pipeline orchestrator.

Per commit, the pipeline composes the subsystem layers:

    CommitStream ──► BenchmarkSelector ──► ResultCache ──► BenchmarkSuite
      (commits.py)      (select.py)          (cache.py)     (registry.py,
                                                             runs on the
                                                             ExecutionEngine)
                                └──────────► HistoryStore ─► RegressionDetector
                                               (history.py)     (detect.py)

Three modes trade platform spend for measurement freshness:

  * ``full`` — every benchmark measured every commit (the naive per-commit
    suite run the paper's CI use case starts from).
  * ``selective`` — only benchmarks whose code fingerprint changed are
    measured, plus periodic A/A revalidation of stale unchanged ones.
  * ``selective_cached`` — as selective, but measurements whose exact
    (fingerprint-pair, config) were measured before are served from the
    result cache instead of the platform.

Every commit's per-benchmark CIs, invocation counts, and attributed costs
land in the history store; the regression detector then scans the history
for changes no single pairwise comparison could flag.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.stats import ChangeResult
from repro_torch.faas.engine import CompletedInvocation, EngineObserver
from repro_torch.cb.cache import ResultCache, config_digest
from repro_torch.cb.commits import Commit
from repro_torch.cb.detect import DetectorConfig, RegressionDetector, RegressionEvent
from repro_torch.cb.history import (HistoryRecord, HistoryStore, SOURCE_BASELINE,
                              SOURCE_CACHE, SOURCE_RUN, SOURCE_SKIP)
from repro_torch.cb.registry import BenchmarkSuite, _commit_seed, get_suite
from repro_torch.cb.select import BenchmarkSelector, SelectorConfig

MODES = ("full", "selective", "selective_cached")


@dataclass
class PipelineConfig:
    suite: str = "synthetic"
    provider: str = "lambda"
    mode: str = "selective_cached"
    n_calls: int = 15
    repeats_per_call: int = 3
    parallelism: int = 150
    memory_mb: int = 2048
    min_results: int = 10
    seed: int = 0
    max_staleness: int = 5
    adaptive: bool = False          # attach the AdaptiveController per run
    engine: object = None           # scheduler core: "fast"/"reference"
    #                                 (None = process default, i.e. the
    #                                 vectorized engine; reports are
    #                                 bit-identical either way)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    chaos: object = None            # faas/chaos.py ChaosConfig (None = calm;
    #                                 zero intensity is a tested identity)

    def config_digest(self) -> str:
        """Cache comparability key: every knob that shapes a measurement.

        An active chaos scenario shapes measurements too — calm cached
        results must never serve a chaos run (or vice versa), so the
        scenario repr joins the digest.  Inactive chaos (None or zero
        intensity) measures identically to calm (the tested identity)
        and keeps the historical digest."""
        kw = dict(suite=self.suite, provider=self.provider,
                  n_calls=self.n_calls,
                  repeats_per_call=self.repeats_per_call,
                  memory_mb=self.memory_mb,
                  min_results=self.min_results,
                  adaptive=self.adaptive)
        if self.chaos is not None and getattr(self.chaos, "active", True):
            kw["chaos"] = repr(self.chaos)
        return config_digest(**kw)


class _BenchmarkMeter(EngineObserver):
    """Attributes engine work to benchmarks: invocation counts and billed
    seconds per benchmark, so history records carry per-benchmark costs."""

    def __init__(self):
        self.invocations: Dict[str, int] = {}
        self.billed_s: Dict[str, float] = {}

    def on_result(self, done: CompletedInvocation) -> None:
        b = done.invocation.benchmark
        self.invocations[b] = self.invocations.get(b, 0) + 1
        self.billed_s[b] = self.billed_s.get(b, 0.0) \
            + done.outcome.duration_s

    # vectorized-engine waves: same tallies from whole arrays.  Dict
    # key order (first event per benchmark) and float sums (cumulative
    # sum seeded from the running total == sequential adds) both match
    # the per-event path bit-for-bit.
    wave_eligible = True

    def on_wave(self, wave) -> None:
        import numpy as np
        if len(wave) == 0:
            return
        combo = wave.combo
        durs = wave.duration_s
        cu, first = np.unique(combo, return_index=True)
        for c in cu[np.argsort(first)].tolist():
            b = wave.combo_bench[c]
            dm = durs[combo == c]
            self.invocations[b] = (self.invocations.get(b, 0)
                                   + int(dm.shape[0]))
            arr = np.empty(dm.shape[0] + 1)
            arr[0] = self.billed_s.get(b, 0.0)
            arr[1:] = dm
            self.billed_s[b] = float(np.cumsum(arr)[-1])


@dataclass
class CommitRun:
    """What the pipeline did for one commit."""
    commit_id: str
    commit_index: int
    ran: List[str]
    revalidated: List[str]
    cache_hits: List[str]
    skipped: List[str]
    changes: Dict[str, ChangeResult]
    flagged: List[str]              # single-pair detections this commit
    invocations: int
    billed_seconds: float
    cost_dollars: float
    wall_seconds: float


@dataclass
class PipelineReport:
    suite: str
    provider: str
    mode: str
    commits: List[CommitRun]
    events: List[RegressionEvent]
    cache_hits: int
    cache_misses: int

    @property
    def total_invocations(self) -> int:
        return sum(c.invocations for c in self.commits)

    @property
    def total_cost(self) -> float:
        return sum(c.cost_dollars for c in self.commits)

    @property
    def total_wall_seconds(self) -> float:
        return sum(c.wall_seconds for c in self.commits)

    @property
    def total_flagged(self) -> int:
        return sum(len(c.flagged) for c in self.commits)

    def commit(self, commit_id: str) -> CommitRun:
        return next(c for c in self.commits if c.commit_id == commit_id)


class Pipeline:
    """Drives a BenchmarkSuite over a commit stream in one of the MODES."""

    def __init__(self, suite: BenchmarkSuite, cfg: Optional[PipelineConfig]
                 = None, *, history: Optional[HistoryStore] = None,
                 cache: Optional[ResultCache] = None):
        self.cfg = cfg or PipelineConfig()
        if self.cfg.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}")
        self.suite = suite
        self.history = history if history is not None else HistoryStore()
        self.cache = cache if cache is not None else ResultCache()
        self.selector = BenchmarkSelector(SelectorConfig(
            max_staleness=self.cfg.max_staleness,
            select_all=self.cfg.mode == "full"))
        self._cfg_digest = self.cfg.config_digest()
        self._obs_clock = 0.0           # cumulative virtual time of inline
        #                                 commit runs (commit spans line up
        #                                 end-to-end on one trace lane)
        self._parent: Optional[Commit] = None
        # authoritative record of the last commit each benchmark truly
        # produced a result at — written at finalize time, in commit
        # order.  The selector's optimistic prepare-time marks are rolled
        # back against THIS (not the prepare-time snapshot, which may
        # itself be an optimistic mark from an earlier preempted commit).
        self._measured_truth: Dict[str, int] = {}

    # ------------------------------------------------------------- stream
    def run_stream(self, commits: List[Commit]) -> PipelineReport:
        """Evaluate a whole stream: commits[0] is the baseline (reference
        version, nothing to compare), each later commit is benchmarked
        against its parent."""
        runs = [self.run_commit(c) for c in commits]
        events = RegressionDetector(self.cfg.detector).scan(
            self.history, provider=self.cfg.provider, mode=self.cfg.mode)
        return PipelineReport(
            suite=self.suite.name, provider=self.cfg.provider,
            mode=self.cfg.mode, commits=[r for r in runs if r is not None],
            events=events, cache_hits=self.cache.hits,
            cache_misses=self.cache.misses)

    # ------------------------------------------------------------- commit
    def run_commit(self, commit: Commit) -> Optional[CommitRun]:
        """Process one commit inline; returns None for the baseline."""
        cfg = self.cfg
        work = self._prepare(commit)
        if work is None:
            return None

        meter = _BenchmarkMeter()
        invocations = 0
        billed = 0.0
        cost = 0.0
        wall = 0.0
        changes: Dict[str, ChangeResult] = {}
        if work.to_measure:
            result = self.suite.run(
                work.to_measure, work.run_commit, provider=cfg.provider,
                n_calls=cfg.n_calls, repeats_per_call=cfg.repeats_per_call,
                parallelism=cfg.parallelism, memory_mb=cfg.memory_mb,
                seed=cfg.seed, min_results=cfg.min_results,
                adaptive=cfg.adaptive, chaos=cfg.chaos, observer=meter,
                engine=cfg.engine)
            changes = result.changes
            rep = result.report
            invocations = len(rep.billed_seconds)
            billed = float(sum(rep.billed_seconds))
            cost = rep.cost_dollars
            wall = rep.wall_seconds
        from repro_torch.obs import get_obs
        obs = get_obs()
        if obs is not None and obs.enabled:
            obs.tracer.span(
                commit.commit_id, cat="commit", ts=self._obs_clock,
                dur=wall, pid=f"cb:{cfg.provider}", tid="commits",
                args={"measured": len(work.to_measure),
                      "cache_hits": len(work.cache_hits),
                      "invocations": invocations, "cost_usd": cost})
        self._obs_clock += wall
        return self._finalize(commit, work, changes, meter.invocations,
                              meter.billed_s, invocations=invocations,
                              billed=billed, cost=cost, wall=wall)

    # ------------------------------------------------------------ service
    def submit_stream(self, commits: List[Commit], service, *,
                      tenant: str = "tenant0", priority: float = 1.0,
                      deadline_s: Optional[float] = None,
                      budget_usd: Optional[float] = None
                      ) -> List[_PendingCommit]:
        """Submit a whole commit stream as service jobs (one job per
        commit that needs measurement) instead of running inline.  The
        returned pending list is consumed by `collect_service` after
        `service.run()`; the service delivers each tenant's results in
        submission order, so history stays causally consistent.

        Selection and cache lookups happen at submission time (they
        depend only on fingerprints); measurements produced by jobs in
        the same batch therefore cannot serve later submissions from the
        cache — they land in the cache at delivery time for future
        streams."""
        from repro_torch.service.jobs import Job
        if self.cfg.adaptive:
            raise ValueError("adaptive stopping is an inline-run feature; "
                             "service jobs run fixed plans chosen by the "
                             "planner")
        cfg = self.cfg
        pending: List[_PendingCommit] = []
        for commit in commits:
            work = self._prepare(commit)
            entry = _PendingCommit(commit, work)
            if work is not None and work.to_measure:
                job = Job(
                    job_id=f"{tenant}/{commit.commit_id}", tenant=tenant,
                    workloads=self.suite.job_workloads(work.to_measure,
                                                       work.run_commit),
                    n_calls=cfg.n_calls,
                    repeats_per_call=cfg.repeats_per_call,
                    priority=priority, deadline_s=deadline_s,
                    budget_usd=budget_usd,
                    seed=_job_seed(cfg.seed, commit),
                    min_results=cfg.min_results,
                    metadata={"suite": self.suite.name,
                              "commit_id": commit.commit_id,
                              "commit_index": commit.index},
                    callback=entry.deliver)
                service.submit(job, provider=cfg.provider,
                               memory_mb=cfg.memory_mb,
                               parallelism=cfg.parallelism)
            pending.append(entry)
        return pending

    def collect_service(self, pending: List[_PendingCommit]
                        ) -> PipelineReport:
        """Finalize delivered jobs into the history (commit order) and
        build the stream report — the service-mode tail of `run_stream`."""
        runs: List[CommitRun] = []
        for entry in pending:
            if entry.work is None:
                continue                     # stream baseline
            if entry.work.to_measure and entry.result is None:
                raise RuntimeError(
                    f"commit {entry.commit.commit_id} was submitted but "
                    f"never delivered — call service.run() first")
            r = entry.result
            if r is None:
                runs.append(self._finalize(entry.commit, entry.work, {},
                                           {}, {}, invocations=0,
                                           billed=0.0, cost=0.0, wall=0.0))
                continue
            runs.append(self._finalize(
                entry.commit, entry.work, r.changes,
                r.benchmark_invocations, r.benchmark_billed_s,
                invocations=r.invocations, billed=r.billed_seconds,
                cost=r.cost_dollars, wall=r.end_s - r.start_s,
                fully_measured=not r.preempted))
        events = RegressionDetector(self.cfg.detector).scan(
            self.history, provider=self.cfg.provider, mode=self.cfg.mode)
        return PipelineReport(
            suite=self.suite.name, provider=self.cfg.provider,
            mode=self.cfg.mode, commits=runs, events=events,
            cache_hits=self.cache.hits, cache_misses=self.cache.misses)

    def run_stream_service(self, commits: List[Commit], service, *,
                           tenant: str = "tenant0", priority: float = 1.0,
                           deadline_s: Optional[float] = None,
                           budget_usd: Optional[float] = None
                           ) -> PipelineReport:
        """`run_stream` through the service: submit every commit as a job,
        execute the service, collect.  With a shared service instance the
        caller submits several pipelines first and calls `service.run()`
        once — this convenience wrapper is the single-tenant path."""
        pending = self.submit_stream(commits, service, tenant=tenant,
                                     priority=priority,
                                     deadline_s=deadline_s,
                                     budget_usd=budget_usd)
        service.run()
        return self.collect_service(pending)

    # ------------------------------------------------- prepare / finalize
    def _prepare(self, commit: Commit) -> Optional["_CommitWork"]:
        """Everything before the platform run: selection, cache lookups,
        selector bookkeeping.  Depends only on fingerprints (never on
        measurement results), so a whole stream can be prepared up front
        and its measurements submitted as concurrent service jobs.
        Returns None for the stream's baseline commit."""
        cfg = self.cfg
        if self._parent is None:
            self.selector.observe_baseline(commit)
            self._measured_truth = {b: commit.index
                                    for b in commit.fingerprints}
            self._parent = commit
            self.history.append([HistoryRecord.from_change(
                None, suite=self.suite.name, provider=cfg.provider,
                mode=cfg.mode, commit_id=commit.commit_id,
                commit_index=commit.index, benchmark=b,
                fingerprint=commit.fingerprints[b], code_changed=False,
                source=SOURCE_BASELINE)
                for b in sorted(commit.fingerprints)])
            return None
        parent = self._parent
        sel = self.selector.select(commit)

        changes: Dict[str, ChangeResult] = {}
        cache_hits: List[str] = []
        to_measure: List[str] = []
        sources: Dict[str, str] = {b: SOURCE_SKIP for b in sel.skipped}
        use_cache = cfg.mode == "selective_cached"
        run_set = set(sel.run)

        def pair_fps(b: str) -> tuple:
            # a changed benchmark measures parent->commit; a revalidation
            # measures the unchanged fingerprint against itself (A/A)
            fp2 = commit.fingerprints[b]
            fp1 = parent.fingerprints.get(b, "") if b in run_set else fp2
            return fp1, fp2

        for b in sel.selected:
            fp1, fp2 = pair_fps(b)
            if use_cache:
                hit = self.cache.get(b, fp1, fp2, self._cfg_digest)
                if hit is not None:
                    res = hit.change_result()
                    if res is not None:
                        changes[b] = res
                    sources[b] = SOURCE_CACHE
                    cache_hits.append(b)
                    continue
            to_measure.append(b)
            sources[b] = SOURCE_RUN

        # revalidations measure A/A: the suite sees a zero step effect
        # for them, which is exactly what an unchanged benchmark is
        reval = set(sel.revalidate) & set(to_measure)
        run_commit = commit if not reval else _strip_steps(commit, reval)
        # selector bookkeeping is fingerprint-only — marking at prepare
        # time (before the measurement) is indistinguishable from the
        # historical post-run marking for the inline path.  A preempted
        # service job can falsify the optimism for benchmarks that never
        # ran, so the pre-mark staleness entries are kept for rollback at
        # finalize time.
        prev_measured = {b: self.selector.last_measured(b)
                         for b in to_measure}
        if to_measure:
            self.selector.mark_measured(to_measure, commit.index)
        if cache_hits:
            self.selector.mark_measured(cache_hits, commit.index)
        self._parent = commit
        from repro_torch.obs import get_obs
        obs = get_obs()
        if obs is not None and obs.enabled:
            prov = cfg.provider
            lane = f"cb:{prov}"
            for b in cache_hits:
                obs.tracer.instant(
                    "cache_hit", cat="cb", ts=self._obs_clock, pid=lane,
                    tid="cache",
                    args={"benchmark": b, "commit": commit.commit_id})
            obs.metrics.inc("cb.commits", provider=prov)
            obs.metrics.inc("cb.benchmarks_selected", len(sel.selected),
                            provider=prov)
            if sel.skipped:
                obs.metrics.inc("cb.selector_skips", len(sel.skipped),
                                provider=prov)
            if cache_hits:
                obs.metrics.inc("cb.cache_hits", len(cache_hits),
                                provider=prov)
        return _CommitWork(parent=parent, sel=sel, cached_changes=changes,
                           cache_hits=cache_hits, to_measure=to_measure,
                           sources=sources, run_commit=run_commit,
                           pair_fps={b: pair_fps(b) for b in sel.selected},
                           prev_measured=prev_measured)

    def _finalize(self, commit: Commit, work: "_CommitWork",
                  run_changes: Dict[str, ChangeResult],
                  meter_inv: Dict[str, int], meter_billed: Dict[str, float],
                  *, invocations: int, billed: float, cost: float,
                  wall: float, fully_measured: bool = True) -> CommitRun:
        """Everything after the measurement: cache fills, history records,
        the CommitRun.  Called inline right after the suite run, or at
        service delivery time (causally ordered per tenant).

        `fully_measured=False` (a preempted service job) suppresses cache
        fills for benchmarks that never ran: caching their empty result
        would make every future selective_cached stream skip re-measuring
        the fingerprint pair, permanently hiding a real change."""
        cfg = self.cfg
        changes = dict(work.cached_changes)
        changes.update(run_changes)
        for b in work.cache_hits:
            self._measured_truth[b] = commit.index
        for b in work.to_measure:
            if not fully_measured and meter_inv.get(b, 0) < cfg.n_calls:
                # preempted before this benchmark got its full plan: a
                # partial (or empty) measurement must not enter the cache
                # as a change=None "result" — a later selective_cached
                # stream would skip re-measuring the pair and hide a real
                # change — and the staleness clock must not credit it
                self.selector.unmark_measured(
                    b, self._measured_truth.get(b,
                                                work.prev_measured.get(b)),
                    commit.index)
                continue
            self._measured_truth[b] = commit.index
            fp1, fp2 = work.pair_fps[b]
            self.cache.put(
                b, fp1, fp2, self._cfg_digest,
                change=changes.get(b),
                invocations=meter_inv.get(b, 0),
                billed_seconds=meter_billed.get(b, 0.0),
                cost_dollars=_prorate(cost, billed,
                                      meter_billed.get(b, 0.0)))

        records = []
        for b in sorted(commit.fingerprints):
            src = work.sources.get(b, SOURCE_SKIP)
            inv_b, billed_b = 0, 0.0
            if src == SOURCE_RUN:
                inv_b = meter_inv.get(b, 0)
                billed_b = meter_billed.get(b, 0.0)
            records.append(HistoryRecord.from_change(
                changes.get(b), suite=self.suite.name, provider=cfg.provider,
                mode=cfg.mode, commit_id=commit.commit_id,
                commit_index=commit.index, benchmark=b,
                fingerprint=commit.fingerprints[b],
                code_changed=commit.fingerprints[b]
                != work.parent.fingerprints.get(b, ""),
                source=src, invocations=inv_b, billed_seconds=billed_b,
                cost_dollars=_prorate(cost, billed, billed_b)))
        self.history.append(records)

        from repro_torch.obs import get_obs
        obs = get_obs()
        if obs is not None and obs.enabled:
            for b in sorted(changes):
                c = changes[b]
                # CI-width convergence: the narrower this histogram's tail
                # gets over a stream, the closer measurements are to the
                # adaptive controller's stopping width
                obs.metrics.observe("cb.ci_width_pct", c.ci_size,
                                    provider=cfg.provider, benchmark=b)
            n_flag = sum(1 for c in changes.values() if c.changed)
            if n_flag:
                obs.metrics.inc("cb.flagged", n_flag,
                                provider=cfg.provider)
        if obs is not None and obs.monitor is not None:
            # convergence-by-time SLO: latest CI width per benchmark on
            # the pipeline's cumulative virtual clock
            for b in sorted(changes):
                obs.monitor.job_event(
                    "ci_width", self._obs_clock, benchmark=b,
                    provider=cfg.provider,
                    width_pct=float(changes[b].ci_size))
            obs.monitor.evaluate(self._obs_clock)

        sel = work.sel
        return CommitRun(
            commit_id=commit.commit_id, commit_index=commit.index,
            ran=[b for b in sel.run if work.sources.get(b) == SOURCE_RUN],
            revalidated=[b for b in sel.revalidate
                         if work.sources.get(b) == SOURCE_RUN],
            cache_hits=work.cache_hits, skipped=sel.skipped, changes=changes,
            flagged=sorted(b for b, c in changes.items() if c.changed),
            invocations=invocations, billed_seconds=billed,
            cost_dollars=cost, wall_seconds=wall)


def _job_seed(seed: int, commit: Commit) -> int:
    """Service jobs reuse the registry's per-commit seed stream, so a
    commit measured through the service draws the same RMIT plan as the
    same commit measured inline."""
    return _commit_seed(seed, commit)


@dataclass
class _CommitWork:
    """Prepared (pre-measurement) state of one non-baseline commit."""
    parent: Commit
    sel: object                             # SelectorResult
    cached_changes: Dict[str, ChangeResult]
    cache_hits: List[str]
    to_measure: List[str]
    sources: Dict[str, str]
    run_commit: Commit                      # A/A-stripped view for the run
    pair_fps: Dict[str, tuple]
    prev_measured: Dict[str, object] = field(default_factory=dict)


@dataclass
class _PendingCommit:
    """One commit travelling through the service: prepared work plus the
    JobResult the service delivers (None for the baseline and for
    commits with nothing to measure)."""
    commit: Commit
    work: Optional[_CommitWork]
    result: object = None                   # repro_torch.service.JobResult

    def deliver(self, result) -> None:
        self.result = result


def _prorate(total_cost: float, total_billed: float, billed_b: float) -> float:
    """Attribute run cost to benchmarks by billed-seconds share (provider
    bills carry per-request and memory terms; the share is the honest
    first-order attribution)."""
    if total_billed <= 0.0:
        return 0.0
    return total_cost * billed_b / total_billed


def _strip_steps(commit: Commit, benchmarks: set) -> Commit:
    """A/A view of a commit for revalidation runs: the listed benchmarks
    keep their fingerprint and level but lose their (zero anyway) step."""
    from dataclasses import replace
    steps = {b: e for b, e in commit.step_effects.items()
             if b not in benchmarks}
    return replace(commit, step_effects=steps)


def run_pipeline(suite_name: str, commits: List[Commit],
                 cfg: Optional[PipelineConfig] = None, *,
                 history: Optional[HistoryStore] = None,
                 cache: Optional[ResultCache] = None,
                 suite_kwargs: Optional[dict] = None) -> PipelineReport:
    """Convenience entry: resolve the suite from the registry and run."""
    cfg = cfg or PipelineConfig()
    suite = get_suite(suite_name if suite_name else cfg.suite,
                      **(suite_kwargs or {}))
    return Pipeline(suite, cfg, history=history,
                    cache=cache).run_stream(commits)
