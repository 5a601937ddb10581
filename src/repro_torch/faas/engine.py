"""The single execution engine behind every platform (paper §4, Figure 2).

One event-driven scheduler owns everything the three former copies of the
execution loop (SimulatedFaaS / SimulatedVM / ElasticController) each
reimplemented: concurrency slots, warm-instance pools with keep-alive
reaping, cold starts, per-benchmark and per-function timeouts, retries of
platform failures, straggler hedging, and billing.  Platforms plug in as
`PlatformBackend`s (see backends.py) and scenarios plug in as
`EngineObserver`s (e.g. the adaptive stopping controller in
core/controller.py) — neither needs to re-implement scheduling.

Two completion sources drive the same scheduling policy:

  * **virtual time** (simulated backends): invocation durations are modeled
    analytically at dispatch, so the event loop advances a virtual clock
    through a heap of (slot_free_time, slot) events.  O(log P) per
    invocation at parallelism P — a 10k-invocation plan at parallelism
    1000 schedules in milliseconds.
  * **real time** (LocalDuetBackend): invocations execute on a thread pool
    and the loop consumes wall-clock completion events, with the same
    retry/hedge policy and the same report.

Results stream to the observer in completion order, and a result is only
delivered once the (virtual) clock has reached its completion time — a
scheduling decision at time t can only use results that exist at t, just
like a real deployment.  That causal stream is what lets the adaptive
controller stop a benchmark mid-run and re-allocate its remaining budget.
"""
from __future__ import annotations

import concurrent.futures as cf
import heapq
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.duet import DuetPair
from repro_torch.core.rmit import Invocation, SuitePlan


@dataclass
class EngineConfig:
    parallelism: int = 150               # paper §6.1
    max_retries: int = 0                 # platform (not benchmark) failures
    hedge_after_factor: float = 0.0      # 0 disables straggler hedging
    hedge_min_samples: int = 8
    hedge_min_s: float = 5.0


@dataclass
class Instance:
    """One provisioned execution environment (container / VM)."""
    iid: str
    speed: float = 1.0                   # heterogeneity factor (1 = nominal)


class WarmPool:
    """Warm-instance pool as two heaps instead of the historical list that
    was rebuilt (O(pool)) on every acquire.  The historical pick was
    "first entry in append order that is idle and unexpired", i.e. the
    idle, unexpired entry with the smallest append sequence number — so
    `_ready` is a min-heap on seq of entries already idle, `_busy` a
    min-heap on idle_since of entries whose instance is still running.
    Dispatch times are non-decreasing, which makes both the busy->ready
    promotion and the lazy expiry drop exact: O(log pool) per acquire.

    A pool may outlive one engine run: the service scheduler keeps one
    pool per provider fleet and passes it to every job's engine run, so
    consecutive jobs reuse each other's warm instances (fewer cold
    starts) exactly like concurrent suites sharing a real fleet.  The
    non-decreasing-time requirement then spans runs: callers sharing a
    pool must share one virtual clock."""

    def __init__(self):
        self._busy: List[Tuple[float, int, Instance]] = []  # (idle_since,..)
        self._ready: List[Tuple[int, float, Instance]] = []  # (seq,..)
        self._seq = 0

    def __len__(self) -> int:
        return len(self._busy) + len(self._ready)

    def release(self, inst: Instance, idle_since: float) -> None:
        heapq.heappush(self._busy, (idle_since, self._seq, inst))
        self._seq += 1

    def acquire(self, t: float, keep_alive_s: float) -> Optional[Instance]:
        """The warm, unexpired instance that has been idle since the
        earliest append, or None (caller cold-starts)."""
        while self._busy and self._busy[0][0] <= t:
            idle_since, seq, inst = heapq.heappop(self._busy)
            if t - idle_since > keep_alive_s:
                continue                  # reaped: never migrates to _ready
            heapq.heappush(self._ready, (seq, idle_since, inst))
        while self._ready:
            _, idle_since, inst = heapq.heappop(self._ready)
            if t - idle_since > keep_alive_s:
                continue                  # reaped (entered _ready earlier,
                #                           expired while queued behind a
                #                           lower-seq pick)
            return inst
        return None


@dataclass
class InvocationOutcome:
    """What a backend reports for one attempted invocation."""
    pairs: List[DuetPair]
    duration_s: float                    # billed duration incl. overheads
    ok: bool
    timed_out: bool = False              # hit the per-benchmark timeout
    platform_failure: bool = False       # transient infra error (retryable)
    benchmark_failure: bool = False      # deterministic (e.g. restricted FS)
    # fault-injection channel (faas/chaos.py); stock backends leave these
    # at their defaults, which keeps every historical code path identical
    lost: bool = False                   # request vanished (platform_failure)
    instance_dead: bool = False          # the instance died: never re-pool it
    duplicates: int = 0                  # extra result deliveries to dedup


@dataclass
class CompletedInvocation:
    """One finished attempt, as streamed to the observer."""
    invocation: Invocation
    outcome: InvocationOutcome
    t_start: float
    t_end: float
    attempt: int
    instance: Optional[Instance] = None
    delivered: bool = False              # dedup mark for duplicate delivery


class CompletedWave:
    """A batch of completed invocations in delivery order (SoA columns).

    The vectorized engine delivers whole validity-truncated waves to
    wave-eligible observers through `EngineObserver.on_wave` instead of
    one `CompletedInvocation` at a time.  Columns are parallel arrays
    (any indexable array type; the vector engine passes ndarrays) and
    the event sequence across successive `on_wave` calls is exactly the
    `on_result` sequence the scalar engine would have produced: same
    events, same (t_end, dispatch-seq) order, final attempts only.

    Pairs are carried as two flat columns (`pair_v1` / `pair_v2`) sliced
    per event by (`pair_off`, `pair_cnt`); per-pair metadata (benchmark,
    call index, instance, cold flag) is the owning event's.  Failed
    events carry no pairs (`pair_cnt == 0`) — the scalar outcome may
    hold a partial prefix there, which no shipping observer reads.
    """

    __slots__ = ("n", "plan_invocations", "gidx", "combo", "combo_bench",
                 "combo_job", "call", "t_start", "t_end", "duration_s",
                 "attempt", "ok", "timed_out", "platform_failure",
                 "benchmark_failure", "cold", "iid_num", "speed",
                 "iid_prefix", "pair_off", "pair_cnt", "pair_v1", "pair_v2")

    def __init__(self, *, n, plan_invocations, gidx, combo, combo_bench,
                 combo_job, call, t_start, t_end, duration_s, attempt, ok,
                 timed_out, platform_failure, benchmark_failure, cold,
                 iid_num, speed, iid_prefix, pair_off, pair_cnt, pair_v1,
                 pair_v2):
        self.n = n
        self.plan_invocations = plan_invocations
        self.gidx = gidx                 # event -> index into the plan
        self.combo = combo               # event -> (job, benchmark) id
        self.combo_bench = combo_bench   # combo id -> benchmark name
        self.combo_job = combo_job       # combo id -> job id ("" if n/a)
        self.call = call
        self.t_start = t_start
        self.t_end = t_end
        self.duration_s = duration_s
        self.attempt = attempt
        self.ok = ok
        self.timed_out = timed_out
        self.platform_failure = platform_failure
        self.benchmark_failure = benchmark_failure
        self.cold = cold
        self.iid_num = iid_num
        self.speed = speed
        self.iid_prefix = iid_prefix
        self.pair_off = pair_off
        self.pair_cnt = pair_cnt
        self.pair_v1 = pair_v1
        self.pair_v2 = pair_v2

    def __len__(self) -> int:
        return self.n

    def invocation(self, i: int) -> Invocation:
        return self.plan_invocations[int(self.gidx[i])]

    def event(self, i: int) -> CompletedInvocation:
        """Materialize event i as the `CompletedInvocation` the scalar
        engine would have delivered (the per-event compatibility shim)."""
        inv = self.invocation(i)
        iid = self.iid_prefix + str(int(self.iid_num[i]))
        cold = bool(self.cold[i])
        off, cnt = int(self.pair_off[i]), int(self.pair_cnt[i])
        name = self.combo_bench[int(self.combo[i])]
        ci = int(self.call[i])
        pairs = [DuetPair(benchmark=name,
                          v1_seconds=float(self.pair_v1[off + r]),
                          v2_seconds=float(self.pair_v2[off + r]),
                          instance_id=iid, call_index=ci, cold_start=cold)
                 for r in range(cnt)]
        out = InvocationOutcome(
            pairs=pairs, duration_s=float(self.duration_s[i]),
            ok=bool(self.ok[i]), timed_out=bool(self.timed_out[i]),
            platform_failure=bool(self.platform_failure[i]),
            benchmark_failure=bool(self.benchmark_failure[i]))
        return CompletedInvocation(
            inv, out, float(self.t_start[i]), float(self.t_end[i]),
            int(self.attempt[i]),
            Instance(iid, float(self.speed[i])), delivered=True)


class EngineObserver:
    """Scenario hook: consumes results incrementally and may reshape the
    remaining schedule.  All methods are called from the scheduling loop
    (never concurrently); `on_result` delivers completed invocations in
    completion order, never before their (virtual) completion time."""

    # Opt-in to wave-batched delivery (the vectorized engine).  An
    # eligible observer promises: (a) `extra_invocations` always returns
    # (); (b) consuming a wave through `on_wave` leaves it in exactly
    # the state the equivalent `on_result` sequence would; (c)
    # `peek_skip` is a side-effect-free preview of `should_skip` whose
    # True answers are *monotone* (once an invocation would be skipped,
    # it is skipped at every later decision time).  Non-eligible
    # observers keep the scalar engine (transparent fallback).
    wave_eligible = False

    def should_skip(self, inv: Invocation) -> bool:
        """Consulted right before dispatch; True drops the invocation
        (it is neither executed nor billed)."""
        return False

    def peek_skip(self, inv: Invocation) -> bool:
        """Pure preview of `should_skip`: same answer, no side effects.
        The vectorized engine consults this speculatively while
        composing a wave and replays `should_skip` only for skips it
        commits."""
        return False

    def skip_possible(self) -> bool:
        """False promises `should_skip` never returns True for the rest
        of the run — the vectorized engine then skips per-invocation
        consultation entirely.  Conservative default: True."""
        return True

    def skip_volatile(self, inv: Invocation) -> bool:
        """False promises this invocation's current `peek_skip` answer
        cannot change for the rest of the run (a constant False, or a
        monotone True): the vectorized engine may then consult it beyond
        the frozen-observer horizon while composing a wave.  True means
        the answer can still flip with future deliveries (e.g. a
        budget-capped job that has not been preempted yet), so the lane
        must stay behind the horizon.  Conservative default: True."""
        return True

    # Exact skip shadow (vectorized engine).  An observer that sets
    # `skip_exact = True` promises `skip_flip_s` returns the *exact*
    # earliest delivery instant at which `peek_skip(inv)` would flip to
    # True given every completion the engine has fed to `skip_shadow`
    # but not yet delivered (math.inf when no buffered delivery can
    # flip it).  The engine may then compose a volatile lane past the
    # frozen-observer horizon whenever the flip provably lands after
    # the lane's scalar check time.
    skip_exact = False

    def skip_shadow(self, combo, t_end, duration_s, combo_bench,
                    combo_job) -> None:
        """Shadow feed (vectorized engine, `skip_exact` only): the
        engine hands over every completion chunk it buffers, in buffer
        order, *before* delivery.  `combo` indexes `combo_bench` /
        `combo_job`; delivery later follows global (t_end, buffer
        order)."""

    def skip_flip_s(self, inv: Invocation) -> float:
        """Exact earliest t_end among shadowed-but-undelivered
        completions whose delivery flips `peek_skip(inv)` to True;
        math.inf when none can."""
        return math.inf

    def on_result(self, done: CompletedInvocation) -> None:
        """Called once per invocation with its final attempt (retried
        platform failures are not delivered individually); failures are
        included."""

    def on_wave(self, wave: CompletedWave) -> None:
        """Batched delivery (vectorized engine, `wave_eligible` only).
        Events arrive in the exact scalar delivery order; the default
        shim replays them through `on_result` one at a time."""
        for i in range(len(wave)):
            self.on_result(wave.event(i))

    def extra_invocations(self) -> Sequence[Invocation]:
        """Drained once per scheduling step; returned invocations join the
        back of the queue (budget reallocation)."""
        return ()


class FanoutObserver(EngineObserver):
    """Composes several observers behind the engine's single observer slot
    (e.g. an adaptive controller plus the pipeline's per-benchmark meter).
    An invocation is skipped if *any* child skips it; results are delivered
    to every child in order; extra invocations are concatenated."""

    def __init__(self, observers: Sequence[EngineObserver]):
        self.observers = list(observers)

    @property
    def wave_eligible(self) -> bool:
        # a composite is only as batchable as its least batchable child
        return all(getattr(obs, "wave_eligible", False)
                   for obs in self.observers)

    def should_skip(self, inv: Invocation) -> bool:
        # generator, not a list: short-circuits at the first skipper, so
        # children after it are not consulted (and pay no work) for an
        # invocation that is already dropped
        return any(obs.should_skip(inv) for obs in self.observers)

    def peek_skip(self, inv: Invocation) -> bool:
        return any(obs.peek_skip(inv) for obs in self.observers)

    def skip_possible(self) -> bool:
        return any(obs.skip_possible() for obs in self.observers)

    def skip_volatile(self, inv: Invocation) -> bool:
        # a child that can never skip has constant answers
        return any(obs.skip_possible() and obs.skip_volatile(inv)
                   for obs in self.observers)

    def on_result(self, done: CompletedInvocation) -> None:
        for obs in self.observers:
            obs.on_result(done)

    def on_wave(self, wave: CompletedWave) -> None:
        for obs in self.observers:
            obs.on_wave(wave)

    def extra_invocations(self) -> Sequence[Invocation]:
        out: List[Invocation] = []
        for obs in self.observers:
            out.extend(obs.extra_invocations())
        return out


@dataclass
class EngineReport:
    """Superset of the old SimReport / RunReport accounting."""
    pairs: List[DuetPair]
    wall_seconds: float
    billed_seconds: List[float]
    cost_dollars: float
    cold_starts: int
    timeouts: int
    failures: int
    executed_benchmarks: List[str]
    failed_benchmarks: List[str]
    invocations_done: int = 0
    invocations_failed: int = 0
    retries: int = 0
    hedged: int = 0
    skipped: int = 0
    lost: int = 0                        # attempts that vanished (chaos)
    duplicates_dropped: int = 0          # duplicate deliveries deduplicated


class _HedgePolicy:
    """Straggler-hedging rule shared by the virtual and realtime loops:
    hedge an invocation running longer than max(factor * median duration,
    hedge_min_s), once at least hedge_min_samples have completed.  The
    median is recomputed lazily (only after the sample count grows ~12%)
    so large virtual plans stay O(N log N) overall."""

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self._durations: List[float] = []
        self._median: Optional[float] = None
        self._computed_at = 0

    def record(self, duration_s: float) -> None:
        self._durations.append(duration_s)

    def threshold(self) -> Optional[float]:
        cfg = self.cfg
        if cfg.hedge_after_factor <= 0:
            return None
        n = len(self._durations)
        if n < cfg.hedge_min_samples:
            return None
        if (self._median is None
                or n - self._computed_at >= max(1, self._computed_at // 8)):
            self._median = sorted(self._durations)[n // 2]
            self._computed_at = n
        return max(cfg.hedge_after_factor * self._median, cfg.hedge_min_s)


class ExecutionEngine:
    """Event-driven scheduler running a SuitePlan against one backend."""

    def __init__(self, backend, cfg: Optional[EngineConfig] = None):
        self.backend = backend
        self.cfg = cfg or EngineConfig()
        self._lock = threading.Lock()

    def run(self, plan: SuitePlan,
            observer: Optional[EngineObserver] = None, *,
            warm_pool: Optional[WarmPool] = None,
            start_s: float = 0.0) -> EngineReport:
        """`warm_pool` lets a caller share warm instances across runs (the
        service scheduler's per-fleet pools); `start_s` starts every
        concurrency slot at that virtual time instead of 0 so a shared
        pool's non-decreasing-clock requirement holds across runs."""
        if getattr(self.backend, "realtime", False):
            return self._run_realtime(plan, observer)
        return self._run_virtual(plan, observer, warm_pool, start_s)

    # ------------------------------------------------------------- virtual
    def _run_virtual(self, plan: SuitePlan,
                     observer: Optional[EngineObserver],
                     warm_pool: Optional[WarmPool] = None,
                     start_s: float = 0.0) -> EngineReport:
        cfg, be = self.cfg, self.backend
        be.begin_run(cfg.parallelism)

        # observability is resolved ONCE per run into locals; the
        # disabled path then costs a single `is not None` branch per
        # dispatch (priced by engine_bench.py --trace-overhead).  The
        # tracer/metrics only read values computed below — never an RNG
        # draw, never a reorder — so reports are bit-identical either way.
        from repro_torch.obs import get_obs
        _obs = get_obs()
        tr = _obs.tracer if (_obs is not None and _obs.enabled) else None
        mx = _obs.metrics if (_obs is not None and _obs.enabled) else None
        provider = getattr(getattr(be, "profile", None), "name", None) \
            or type(be).__name__
        lane = f"fleet:{provider}"
        # active monitoring (SLOs + detectors) rides the same resolve-once
        # contract: the windowed feed is fetched here, and each dispatch
        # pays one extra `is not None` branch when monitoring is off
        mon = _obs.monitor if _obs is not None else None
        mfeed = mon.engine_feed(provider) if mon is not None else None

        pairs: List[DuetPair] = []
        billed: List[float] = []
        cold_starts = timeouts = failures = 0
        done_n = failed_n = retries = hedged = skipped = 0
        lost_n = dup_dropped = 0
        executed: set = set()
        failed: set = set()
        wall = 0.0
        hedge = _HedgePolicy(cfg)

        # slot = one concurrency lane; (free_time, slot_idx) min-heap gives
        # O(log P) selection with the lowest-index tie-break the O(P) scan
        # used to have.
        slots: List[Tuple[float, int]] = [(start_s, i)
                                          for i in range(cfg.parallelism)]
        pool = warm_pool if warm_pool is not None else WarmPool()
        pinned: Dict[int, Instance] = {}          # slot -> fixed instance

        def acquire(inv: Invocation, slot: int, t: float):
            """Warm-pool reuse (elastic platforms) or slot-pinned instances
            (fixed VM fleets); returns (instance, cold_overhead_s, cold)."""
            nonlocal cold_starts
            if be.pinned:
                inst = pinned.get(slot)
                if inst is None:
                    inst, _ = be.spawn_instance(inv, t, slot)
                    pinned[slot] = inst
                return inst, 0.0, False
            inst = pool.acquire(t, be.keep_alive_s)
            if inst is not None:
                return inst, 0.0, False
            inst, overhead = be.spawn_instance(inv, t, slot)
            cold_starts += 1
            return inst, overhead, True

        def dispatch(inv: Invocation, attempt: int) -> CompletedInvocation:
            t, slot = heapq.heappop(slots)
            inst, overhead, cold = acquire(inv, slot, t)
            out = be.simulate(inv, inst, t, overhead)
            t_end = t + out.duration_s
            heapq.heappush(slots, (t_end, slot))
            if not be.pinned and not out.instance_dead:
                # a dead instance never re-enters the warm pool: a retry
                # of this invocation must re-draw cold-start state, not
                # re-acquire the corpse's warm slot (it would fail again)
                pool.release(inst, t_end)
            if tr is not None:
                tr.span(inv.benchmark, cat="invoke", ts=t,
                        dur=out.duration_s, pid=lane,
                        tid=f"slot{slot:03d}",
                        args={"job": inv.job_id, "attempt": attempt,
                              "cold": cold, "ok": out.ok,
                              "instance": inst.iid})
                if cold:
                    tr.instant("cold_start", cat="engine", ts=t, pid=lane,
                               tid=f"slot{slot:03d}",
                               args={"overhead_s": overhead})
            if mx is not None:
                mx.inc("engine.invocations", provider=provider,
                       benchmark=inv.benchmark)
                mx.inc("engine.billed_s", out.duration_s,
                       provider=provider, benchmark=inv.benchmark)
                mx.observe("engine.latency_s", out.duration_s,
                           provider=provider, benchmark=inv.benchmark)
                if cold:
                    mx.inc("engine.cold_starts", provider=provider)
                else:
                    mx.inc("engine.warm_hits", provider=provider)
            if mfeed is not None:
                mfeed.dispatch(t, out.duration_s, cold, out.ok,
                               out.timed_out)
            return CompletedInvocation(inv, out, t, t_end, attempt, inst)

        # completed invocations are delivered to the observer in virtual
        # completion order, and only once the clock has reached their
        # t_end — a scheduling decision at virtual time t may only use
        # results that exist at t, exactly like a real deployment
        completions: List[tuple] = []    # (t_end, seq, CompletedInvocation)
        comp_seq = 0

        def deliver_due(now: Optional[float]) -> None:
            nonlocal dup_dropped
            while completions and (now is None or completions[0][0] <= now):
                _, _, c = heapq.heappop(completions)
                if c.delivered:
                    # at-least-once platforms may deliver a completion
                    # twice; the engine dedups so an observer sees every
                    # result exactly once and nothing is double-counted
                    dup_dropped += 1
                    continue
                c.delivered = True
                observer.on_result(c)

        queue: deque = deque((inv, 0) for inv in plan.invocations)
        while True:
            if observer is not None:
                queue.extend((inv, 0) for inv in observer.extra_invocations())
            if not queue:
                if observer is not None and completions:
                    # advance the clock to the next completion: delivering
                    # it may unlock top-ups that re-fill the queue
                    deliver_due(completions[0][0])
                    continue
                break
            inv, attempt = queue.popleft()
            if observer is not None:
                deliver_due(slots[0][0])     # results known by dispatch time
                if attempt == 0 and observer.should_skip(inv):
                    skipped += 1
                    continue

            comp = dispatch(inv, attempt)
            out = comp.outcome
            billed.append(out.duration_s)
            end_s = comp.t_end

            # straggler hedging: a known-long invocation is re-issued on
            # the next free slot; the earlier (virtual) successful
            # completion wins and the losing twin is *cancelled* at that
            # moment — the platform bills the loser only until the cancel
            # signal, never for the duration it would have run.  (The
            # loser's slot still frees at its originally modeled end: a
            # cancel does not reschedule work already dispatched behind
            # it, so the schedule stays identical and only billing/wall
            # accounting sees the cancellation.)
            thr = hedge.threshold()
            if thr is not None and out.duration_s > thr:
                hedged += 1
                alt = dispatch(inv, attempt)
                if tr is not None:
                    tr.instant("hedge", cat="engine", ts=alt.t_start,
                               pid=lane, tid=f"b:{inv.benchmark}",
                               args={"threshold_s": thr,
                                     "original_dur_s": out.duration_s})
                if mx is not None:
                    mx.inc("engine.hedges", provider=provider)
                alt_billed = alt.outcome.duration_s
                alt_end = alt.t_end
                if alt.outcome.ok and (not out.ok or alt.t_end < comp.t_end):
                    if alt.t_end < comp.t_end:
                        # the twin wins while the original is still
                        # running: cancel the original at the twin's end
                        billed[-1] = max(0.0, min(out.duration_s,
                                                  alt.t_end - comp.t_start))
                        end_s = alt.t_end
                    comp, out = alt, alt.outcome
                elif out.ok:
                    # the original won: the twin is cancelled at the
                    # original's end (0 s billed if not yet started)
                    alt_billed = max(0.0, min(alt_billed,
                                              comp.t_end - alt.t_start))
                    alt_end = min(alt_end, max(comp.t_end, alt.t_start))
                billed.append(alt_billed)
                wall = max(wall, alt_end)
            wall = max(wall, end_s)

            if out.lost:
                lost_n += 1
            if out.platform_failure and attempt < cfg.max_retries:
                retries += 1
                if tr is not None:
                    tr.instant("retry", cat="engine", ts=comp.t_end,
                               pid=lane, tid=f"b:{inv.benchmark}",
                               args={"attempt": attempt + 1,
                                     "lost": out.lost})
                if mx is not None:
                    mx.inc("engine.retries", provider=provider)
                queue.appendleft((inv, attempt + 1))
                continue

            name = inv.benchmark
            if out.timed_out:
                timeouts += 1
            if out.ok:
                done_n += 1
                executed.add(name)
                pairs.extend(out.pairs)
                hedge.record(out.duration_s)
            else:
                failed_n += 1
                if out.platform_failure:
                    # transient infra error: the invocation is lost but the
                    # benchmark itself is not condemned
                    failures += 1
                else:
                    failed.add(name)
                    if out.benchmark_failure:
                        failures += 1
            if observer is not None:
                heapq.heappush(completions, (comp.t_end, comp_seq, comp))
                comp_seq += 1
                for _ in range(out.duplicates):
                    # duplicate delivery: the same completion arrives
                    # again; deliver_due drops it (exactly-once to the
                    # observer, billed exactly once at dispatch)
                    heapq.heappush(completions, (comp.t_end, comp_seq,
                                                 comp))
                    comp_seq += 1
            else:
                dup_dropped += out.duplicates

        cost = be.finalize(billed, wall)
        if mx is not None:
            n_disp = len(billed)        # one entry per dispatch incl. twins
            span = cfg.parallelism * max(wall - start_s, 0.0)
            if span > 0:
                mx.set_gauge("engine.slot_utilization",
                             min(1.0, sum(billed) / span),
                             provider=provider)
            if n_disp:
                mx.set_gauge("engine.warm_hit_rate",
                             1.0 - cold_starts / n_disp, provider=provider)
                mx.set_gauge("engine.cold_start_rate",
                             cold_starts / n_disp, provider=provider)
            mx.inc("engine.cost_usd", cost, provider=provider)
        if mon is not None:
            # drain detectors/SLO evaluators up to this run's horizon;
            # evaluate() is monotone so interleaved fleet runs are safe
            mon.evaluate(wall)
        return EngineReport(
            pairs=pairs, wall_seconds=wall, billed_seconds=billed,
            cost_dollars=cost, cold_starts=cold_starts, timeouts=timeouts,
            failures=failures,
            executed_benchmarks=sorted(executed - failed),
            failed_benchmarks=sorted(failed),
            invocations_done=done_n, invocations_failed=failed_n,
            retries=retries, hedged=hedged, skipped=skipped,
            lost=lost_n, duplicates_dropped=dup_dropped)

    # ------------------------------------------------------------ realtime
    def _run_realtime(self, plan: SuitePlan,
                      observer: Optional[EngineObserver]) -> EngineReport:
        cfg, be = self.cfg, self.backend
        be.begin_run(cfg.parallelism)
        t_start = time.monotonic()
        pairs: List[DuetPair] = []
        billed: List[float] = []
        hedge = _HedgePolicy(cfg)
        # shared mutable state: every mutation from pool threads happens
        # under self._lock (the old controller raced on these counters)
        state = {"done": 0, "failed": 0, "retries": 0}
        executed: set = set()
        timeout_failed: set = set()      # deterministic: always condemned
        infra_failed: set = set()        # transient: condemned only if the
        #                                  benchmark never succeeded at all
        hedged = skipped = timeouts = 0

        def attempt(inv: Invocation, tries_left: int):
            """Returns (pairs_or_None, exception_or_None, started, ended).
            Per-benchmark accounting happens in the main loop — a hedge
            duplicate and its original race under first-success-wins, so
            neither a late nor an early failed duplicate may condemn a
            benchmark whose other attempt succeeded."""
            t0 = time.monotonic()
            try:
                res = be.execute(inv)
            except Exception as exc:
                # benchmark timeouts are deterministic — re-running would
                # burn another full timeout for the same outcome; only
                # transient platform failures are worth a retry
                if tries_left > 0 and not isinstance(exc, TimeoutError):
                    with self._lock:
                        state["retries"] += 1
                    return attempt(inv, tries_left - 1)
                return None, exc, t0, time.monotonic()
            t1 = time.monotonic()
            with self._lock:
                hedge.record(t1 - t0)
                billed.append(t1 - t0)
            return res, None, t0, t1

        invocations = list(plan.invocations)
        with cf.ThreadPoolExecutor(max_workers=cfg.parallelism) as pool:
            futs: Dict[cf.Future, int] = {}
            # submit in waves (at most one fleet's worth outstanding) so an
            # observer can still skip work that results have made redundant
            submit_queue: deque = deque(enumerate(invocations))
            completed_idx: set = set()   # first *successful* result wins; a
            # failure only counts once no twin attempt remains in flight
            outstanding: Dict[int, int] = {}     # idx -> attempts in flight
            pending: set = set()

            def fill_pool() -> int:
                nonlocal skipped
                processed = 0
                while submit_queue and len(pending) < cfg.parallelism:
                    i, inv = submit_queue.popleft()
                    processed += 1
                    if observer is not None and observer.should_skip(inv):
                        skipped += 1
                        continue
                    f = pool.submit(attempt, inv, cfg.max_retries)
                    # straggler clock starts at submit: hedging used to
                    # stamp this when the future was first *seen* pending,
                    # deferring every hedge by up to one wait cycle
                    f._repro_t0 = time.monotonic()
                    futs[f] = i
                    outstanding[i] = outstanding.get(i, 0) + 1
                    pending.add(f)
                return processed

            def refill():
                # alternate top-up drains and submissions to a fixpoint:
                # fill_pool's skips release budget that may unlock top-ups,
                # which in turn need submitting — a single pass would drop
                # re-allocations triggered by tail skips
                while True:
                    added = False
                    if observer is not None:
                        for inv in observer.extra_invocations():
                            invocations.append(inv)
                            submit_queue.append((len(invocations) - 1, inv))
                            added = True
                    moved = fill_pool()
                    if not added and not moved:
                        return

            while True:
                refill()
                if not pending:
                    break
                fin, pending = cf.wait(pending, timeout=0.5,
                                       return_when=cf.FIRST_COMPLETED)
                now = time.monotonic()
                for f in fin:
                    idx = futs[f]
                    outstanding[idx] -= 1
                    if idx in completed_idx:
                        continue
                    res, exc, a_start, a_end = f.result()
                    if res is None and outstanding[idx] > 0:
                        # another attempt (the hedge twin) is still running
                        # and may yet succeed: defer judgement to it
                        continue
                    completed_idx.add(idx)
                    inv = invocations[idx]
                    # a benchmark-timeout is deterministic; anything else
                    # from the backend counts as a platform failure
                    timed_out = isinstance(exc, TimeoutError)
                    if res is not None:
                        state["done"] += 1
                        executed.add(inv.benchmark)
                        pairs.extend(res)
                    else:
                        state["failed"] += 1
                        if timed_out:
                            timeouts += 1
                            timeout_failed.add(inv.benchmark)
                        else:
                            infra_failed.add(inv.benchmark)
                    if observer is not None:
                        out = InvocationOutcome(
                            pairs=res or [], duration_s=a_end - a_start,
                            ok=res is not None, timed_out=timed_out,
                            platform_failure=exc is not None
                            and not timed_out,
                            benchmark_failure=timed_out)
                        observer.on_result(CompletedInvocation(
                            inv, out, a_start - t_start, a_end - t_start, 0))
                # straggler hedging: re-issue long-running invocations once
                with self._lock:
                    threshold = hedge.threshold()
                if threshold is not None:
                    for f in list(pending):
                        idx = futs[f]
                        if (now - f._repro_t0 > threshold
                                and not getattr(f, "_repro_hedged", False)):
                            f._repro_hedged = True
                            hedged += 1
                            nf = pool.submit(attempt, invocations[idx], 0)
                            nf._repro_t0 = time.monotonic()
                            futs[nf] = idx
                            outstanding[idx] = outstanding.get(idx, 0) + 1
                            pending.add(nf)

        wall = time.monotonic() - t_start
        cost = be.finalize(billed, wall)
        # mirror the virtual path: a transient infra failure doesn't condemn
        # a benchmark with good results, but one that never succeeded is
        # still reported failed (the historical controller contract)
        failed_benchmarks = timeout_failed | (infra_failed - executed)
        return EngineReport(
            pairs=pairs, wall_seconds=wall, billed_seconds=billed,
            cost_dollars=cost, cold_starts=0, timeouts=timeouts,
            failures=state["failed"],
            executed_benchmarks=sorted(executed - failed_benchmarks),
            failed_benchmarks=sorted(failed_benchmarks),
            invocations_done=state["done"],
            invocations_failed=state["failed"],
            retries=state["retries"], hedged=hedged, skipped=skipped)
