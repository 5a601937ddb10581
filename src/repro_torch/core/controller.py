"""Benchmarking controllers (paper §4, Figure 2 + adaptive extension).

`ElasticController` fans a SuitePlan out over a worker fleet with bounded
instance parallelism, enforcing per-invocation timeouts, retrying platform
failures, and hedging stragglers.  It is a thin wrapper over the shared
event-driven engine (faas/engine.py) with the real-execution backend
(faas/backends.py LocalDuetBackend): PyTorch duets timed on the CUDA card
or, when asked, on the host CPU.  The simulated platforms run through the *same*
engine with virtual-time backends.

`AdaptiveController` implements adaptive repeat allocation in the spirit of
Rese et al. 2024: it consumes results as they stream out of the engine,
stops invoking a benchmark once the bootstrap CI of its median relative
difference is tight enough, and re-allocates the freed invocation budget to
benchmarks that are still noisy (wide CI) — matching fixed-RMIT detection
at a fraction of the billed cost.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.core import rmit
from repro_torch.core.duet import DuetPair, DuetRunnable
from repro_torch.core.results import StreamingAnalyzer
from repro_torch.core.rmit import Invocation, SuitePlan
from repro_torch.faas.backends import LocalDuetBackend
from repro_torch.faas.engine import (CompletedInvocation, EngineConfig,
                               EngineObserver, ExecutionEngine)


@dataclass
class ControllerConfig:
    max_parallelism: int = 150          # paper §6.1
    invocation_timeout_s: float = 900.0  # FaaS platform cap (15 min)
    benchmark_timeout_s: float = 20.0    # per-microbenchmark cap (paper §6.1)
    max_retries: int = 1                 # platform failures
    hedge_after_factor: float = 4.0      # straggler: > factor x median runtime
    hedge_min_samples: int = 8
    hedge_min_s: float = 5.0             # never hedge before this elapsed time
    min_results: int = 10                # paper §6.1 filter


@dataclass
class RunReport:
    pairs: List[DuetPair]
    wall_seconds: float
    invocations_done: int
    invocations_failed: int
    retries: int
    hedged: int
    failed_benchmarks: List[str] = field(default_factory=list)


class ElasticController:
    """Real-execution fan-out: thin wrapper binding the shared engine to
    the thread-pool duet backend."""

    def __init__(self, duets: Dict[str, DuetRunnable],
                 cfg: Optional[ControllerConfig] = None):
        self.duets = duets
        self.cfg = cfg or ControllerConfig()

    def run_suite(self, plan: SuitePlan,
                  observer: Optional[EngineObserver] = None) -> RunReport:
        cfg = self.cfg
        backend = LocalDuetBackend(
            self.duets, benchmark_timeout_s=cfg.benchmark_timeout_s,
            invocation_timeout_s=cfg.invocation_timeout_s)
        engine = ExecutionEngine(backend, EngineConfig(
            parallelism=cfg.max_parallelism, max_retries=cfg.max_retries,
            hedge_after_factor=cfg.hedge_after_factor,
            hedge_min_samples=cfg.hedge_min_samples,
            hedge_min_s=cfg.hedge_min_s))
        rep = engine.run(plan, observer=observer)
        return RunReport(pairs=rep.pairs, wall_seconds=rep.wall_seconds,
                         invocations_done=rep.invocations_done,
                         invocations_failed=rep.invocations_failed,
                         retries=rep.retries, hedged=rep.hedged,
                         failed_benchmarks=rep.failed_benchmarks)


# ----------------------------------------------------------------- adaptive
@dataclass
class AdaptiveConfig:
    """Knobs of the adaptive stopping controller.

    target_ci_pct       stop a benchmark once the bootstrap CI width of its
                        median relative difference is <= this many
                        percentage points
    margin_pct          also stop once the CI excludes zero by at least
                        this margin (the change is confirmed; further
                        repeats cannot un-detect it)
    null_band_pct       also stop once the CI lies entirely inside
                        [-null_band, +null_band] (confirmed null: any true
                        effect is below the suite's detection floor)
    min_results         paper §6.1 filter: benchmarks below it are dropped
                        from the analysis entirely
    stop_min_results    never early-stop before this many pairs (a stop
                        decision on very few samples is fragile: one
                        outlier pair can flip the final CI)
    max_results         per-benchmark ceiling for re-allocated repeats
                        (paper Fig. 7 explores up to 135)
    check_n_boot        bootstrap resamples for the interim CI checks.
                        The controller's analyzer doubles as the run's
                        final analysis (see `analyzer`), so this is also
                        the final bootstrap budget and a stop decision can
                        never be contradicted by the reported CIs
    topup_calls         invocations granted per re-allocation step
    fail_skip_after     consecutive failed invocations before the remaining
                        budget of a benchmark is released (e.g. the
                        restricted-FS failures are deterministic)
    reallocate_frac     fraction of the *saved* invocations that may be
                        re-spent on noisy benchmarks (<=1 guarantees the
                        adaptive run never exceeds the fixed plan's count)
    robust              "none" | "trim" | "winsor": the outlier-fenced CI
                        variants (core/stats.py) for every interim check
                        *and* the final analysis — on a chaos-perturbed
                        platform (faas/chaos.py) contaminated pairs
                        otherwise keep CIs wide and the controller never
                        stops early
    """
    target_ci_pct: float = 2.0
    margin_pct: float = 1.25
    null_band_pct: float = 2.0
    min_results: int = 10
    stop_min_results: int = 15
    max_results: int = 135
    check_n_boot: int = 1000
    topup_calls: int = 3
    fail_skip_after: int = 3
    reallocate_frac: float = 0.25
    seed: int = 0
    robust: str = "none"


@dataclass
class AdaptiveSummary:
    stopped_early: List[str]            # CI target reached before the plan ran out
    gave_up: List[str]                  # released after consecutive failures
    topped_up: Dict[str, int]           # benchmark -> extra invocations granted
    invocations_skipped: int
    invocations_added: int


class AdaptiveController(EngineObserver):
    """Engine observer implementing CI-width early stopping + budget
    re-allocation.  Attach to any backend via `engine.run(plan, observer=...)`
    or the platform wrappers' `observer=` parameter."""

    def __init__(self, plan: SuitePlan, cfg: Optional[AdaptiveConfig] = None):
        self.cfg = cfg or AdaptiveConfig()
        self.plan = plan
        self._analyzer = StreamingAnalyzer(
            n_boot=self.cfg.check_n_boot, seed=self.cfg.seed,
            min_results=self.cfg.min_results, robust=self.cfg.robust)
        self._pending = Counter(inv.benchmark for inv in plan.invocations)
        self._next_call: Dict[str, int] = {
            b: plan.n_calls for b in self._pending}
        self._stopped: Set[str] = set()          # decided: no more repeats
        self._stopped_early: Set[str] = set()    # decided with budget left
        self._gave_up: Set[str] = set()
        self._fails: Counter = Counter()
        self._checked_at: Dict[str, int] = {}
        self._ready: List[str] = []     # pending hit 0, awaiting a decision
        self._topped_up: Counter = Counter()
        self._skipped = 0
        self._added = 0

    # ------------------------------------------------------------ observer
    def should_skip(self, inv: Invocation) -> bool:
        b = inv.benchmark
        if b in self._stopped or b in self._gave_up:
            self._account_done(b)
            self._skipped += 1
            return True
        return False

    def on_result(self, done: CompletedInvocation) -> None:
        b = done.invocation.benchmark
        out = done.outcome
        if out.ok:
            self._fails[b] = 0
            self._analyzer.add_pairs(out.pairs)
        else:
            self._fails[b] += 1
            if self._fails[b] >= self.cfg.fail_skip_after:
                self._gave_up.add(b)
        self._account_done(b)
        if out.ok:
            self._maybe_stop(b)     # after accounting: a stop is only
                                    # "early" if invocations remain to skip

    def extra_invocations(self) -> Sequence[Invocation]:
        if not self._ready:
            return ()
        cfg = self.cfg
        out: List[Invocation] = []
        ready, self._ready = self._ready, []
        # one vectorized bootstrap pass warms the analyzer cache for every
        # dirty candidate; the per-benchmark `_decided` checks below then
        # hit the cache instead of re-bootstrapping one at a time
        self._analyzer.results([b for b in ready
                                if b not in self._stopped
                                and b not in self._gave_up])
        for b in ready:
            if b in self._stopped or b in self._gave_up:
                continue
            n = self._analyzer.n_pairs(b)
            if n == 0 or n >= cfg.max_results:
                continue
            if n >= cfg.stop_min_results and self._decided(b):
                self._stop(b)            # settled, nothing more needed
                continue
            grant = min(cfg.topup_calls, self._credits())
            if grant <= 0:
                self._ready.append(b)    # re-examine once credits accrue
                continue
            extra = rmit.extra_invocations(
                b, n_calls=grant, repeats_per_call=self.plan.repeats_per_call,
                start_call_index=self._next_call[b], seed=cfg.seed)
            self._next_call[b] += grant
            self._pending[b] += grant
            self._topped_up[b] += grant
            self._added += grant
            out.extend(extra)
        return out

    # ------------------------------------------------------------- helpers
    def _account_done(self, b: str) -> None:
        self._pending[b] -= 1
        if self._pending[b] <= 0:
            self._ready.append(b)

    def _credits(self) -> int:
        return int(self._skipped * self.cfg.reallocate_frac) - self._added

    def _decided(self, b: str) -> bool:
        """The stopping rule: precision target reached, change confirmed
        with margin, or null confirmed (CI inside the noise band)."""
        cfg = self.cfg
        res = self._analyzer.result(b)
        if res is None:
            return False
        if res.ci_size <= cfg.target_ci_pct:
            return True
        if res.changed:
            margin = res.ci_low if res.ci_low > 0 else -res.ci_high
            return margin >= cfg.margin_pct
        return (res.ci_low >= -cfg.null_band_pct
                and res.ci_high <= cfg.null_band_pct)

    def _maybe_stop(self, b: str) -> None:
        cfg = self.cfg
        n = self._analyzer.n_pairs(b)
        if n < cfg.stop_min_results or self._checked_at.get(b) == n:
            return
        self._checked_at[b] = n
        if self._decided(b):
            self._stop(b)

    def _stop(self, b: str) -> None:
        self._stopped.add(b)
        if self._pending[b] > 0:
            # planned invocations remain to be skipped: a genuine saving,
            # not just a decision reached on the final planned repeat
            self._stopped_early.add(b)

    @property
    def analyzer(self) -> StreamingAnalyzer:
        """The streaming analysis this controller decided on.  Use its
        `analyze()` as the run's final analysis: bootstrap CIs are
        order-sensitive (index resampling), and only the analyzer holds the
        pairs in the completion order the stop decisions saw — re-analyzing
        dispatch-ordered report pairs could contradict a stop decision."""
        return self._analyzer

    def summary(self) -> AdaptiveSummary:
        return AdaptiveSummary(
            stopped_early=sorted(self._stopped_early),
            gave_up=sorted(self._gave_up),
            topped_up=dict(self._topped_up),
            invocations_skipped=self._skipped,
            invocations_added=self._added)
