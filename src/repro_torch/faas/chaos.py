"""Fault injection for platform backends (chaos layer).

Architecture
------------
`ChaosBackend` wraps any *virtual-time* `PlatformBackend` (backends.py)
and perturbs what the platform reports to the engine, without ever
touching the wrapped backend's RNG stream:

    engine ── ChaosBackend ── SimFaaSBackend / VMBackend / _JobRouterBackend

Two perturbation families compose:

  * **regimes** (traces.py): time-varying performance — diurnal drift,
    per-region heterogeneity, cold-start spike windows, and Markov
    noisy-neighbor bursts.  Smooth regime factors apply to a whole
    invocation, so they inflate durations/billing/timeouts but cancel in
    the within-instance duet diffs (the paper's point).  Noisy-neighbor
    bursts additionally contaminate *individual timings* (interference
    varies at sub-invocation timescale), which is what stresses the
    detector: contaminated pairs have wildly asymmetric diffs.
  * **faults** (`FaultSpec`): discrete platform misbehavior —
    - ``loss``: the invocation vanishes (retryable platform failure,
      zero billed seconds);
    - ``timeout_storm``: inside periodic storm windows an invocation
      hangs until its timeout (transient: retryable, full timeout
      billed — retry storms under a high rate);
    - ``duplicate``: the completion is delivered again (at-least-once
      delivery; the engine must dedup, never double-bill);
    - ``zombie``: the instance dies *after* a successful invocation but
      stays in the warm pool; the next acquire hits a dead sandbox
      (``instance_dead``) and the engine must re-draw a cold start
      instead of re-pooling the corpse;
    - ``billing``: the invocation's billed duration is multiplied by
      ``magnitude`` at finalize time (metering anomaly).

Determinism is the conformance contract:

  * every fault decision for an invocation attempt comes from an RNG
    keyed ``(chaos seed, job_id, benchmark, call_index, attempt)`` — a
    pure function of the scenario, independent of how other invocations
    were perturbed, so runs replay bit-for-bit per seed;
  * each fault kind consumes a *fixed slot* of that RNG's first draw
    block, so enabling one fault never shifts another's stream;
  * at ``intensity == 0`` (or no faults/traces) the wrapper is an exact
    identity: it delegates every call untouched and draws nothing —
    zero-intensity chaos replays every golden digest bit-for-bit.

The wrapper refuses realtime backends (thread-pool execution): chaos is
a virtual-time instrument.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.duet import DuetPair
from repro_torch.core.rmit import Invocation
from repro_torch.faas.engine import Instance, InvocationOutcome
from repro_torch.faas.traces import (ColdSpikeTrace, DiurnalTrace,
                               NoisyNeighborTrace, RegionTrace, TraceModel,
                               instance_key)

# fault kinds (FaultSpec.kind)
LOSS = "loss"
TIMEOUT_STORM = "timeout_storm"
DUPLICATE = "duplicate"
ZOMBIE = "zombie"
BILLING = "billing"
FAULT_KINDS = (LOSS, TIMEOUT_STORM, DUPLICATE, ZOMBIE, BILLING)

# fixed uniform-draw slot per fault kind: enabling or disabling one fault
# can never shift the draws another fault sees
_U_SLOT = {ZOMBIE: 0, LOSS: 1, TIMEOUT_STORM: 2, DUPLICATE: 3, BILLING: 4}
_U_BLOCK = 6
_CHAOS_TAG = 977
# storm timeouts inside one storm window before the flight recorder
# calls it a burst and freezes a post-mortem dump
_STORM_BURST_THRESHOLD = 5


@dataclass(frozen=True)
class FaultSpec:
    """One injectable fault, deterministic given (chaos seed, spec).

    rate        per-invocation-attempt probability at intensity 1
                (for ``timeout_storm``: probability inside a window)
    period_s /
    window_s    storm cadence: active `window_s` out of every `period_s`
                (0 period = always eligible)
    phase_s     shifts the cadence so the first window opens at
                `phase_s` instead of t=0 (detector evaluation wants a
                calm baseline before the incident); 0 = historical
                behavior, bit-identical
    magnitude   billing multiplier (``billing``) or duplicate count
                (``duplicate``); unused otherwise
    """
    kind: str
    rate: float
    period_s: float = 0.0
    window_s: float = 0.0
    phase_s: float = 0.0
    magnitude: float = 2.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")

    def in_window(self, t: float) -> bool:
        if self.period_s <= 0.0:
            return True
        return ((t - self.phase_s) % self.period_s) < self.window_s

    def duty_cycle(self) -> float:
        if self.period_s <= 0.0:
            return 1.0
        return min(1.0, self.window_s / self.period_s)


@dataclass(frozen=True)
class ChaosConfig:
    """A chaos scenario: fault specs + trace models + one global dial.

    `intensity` scales every fault rate and trace amplitude; 0 is the
    exact identity (conformance-tested), 1 is the scenario as specified.
    """
    intensity: float = 1.0
    seed: int = 0
    faults: Tuple[FaultSpec, ...] = ()
    traces: Tuple[TraceModel, ...] = ()
    neighbor: Optional[NoisyNeighborTrace] = None
    # within-burst contamination: interference varies at sub-invocation
    # timescale, so each *timing* of a duet pair is hit independently
    # (probability `neighbor_hit`) by a `slowdown x lognormal(0, sigma)`
    # multiplier — one-sided hits produce the wildly asymmetric diffs
    # that stress the detector
    neighbor_sigma: float = 0.6
    neighbor_hit: float = 0.6

    @property
    def active(self) -> bool:
        return (self.intensity > 0.0
                and bool(self.faults or self.traces or self.neighbor))

    def scaled(self, intensity: float) -> "ChaosConfig":
        return replace(self, intensity=float(intensity))

    def fault(self, kind: str) -> Optional[FaultSpec]:
        for f in self.faults:
            if f.kind == kind:
                return f
        return None

    def cost_model(self, *, max_retries: int = 0) -> "ChaosCostModel":
        """Analytic expectation summary for the deadline/cost planner:
        how many attempts a planned invocation costs, how much slower it
        runs, and how inflated its bill is under this scenario."""
        s = self.intensity
        p_retry = 0.0
        burn = 0.0
        billing_inflation = 1.0
        for f in self.faults:
            rate = min(1.0, f.rate * s)
            if f.kind in (LOSS, ZOMBIE):
                p_retry += rate
            elif f.kind == TIMEOUT_STORM:
                eff = rate * f.duty_cycle()
                p_retry += eff
                burn += eff
            elif f.kind == BILLING:
                billing_inflation += rate * (f.magnitude - 1.0)
        p_retry = min(0.95, p_retry)
        r = max(0, max_retries)
        attempts = ((1.0 - p_retry ** (r + 1)) / (1.0 - p_retry)
                    if p_retry > 0.0 else 1.0)
        slowdown = 1.0
        for tr in self.traces:
            slowdown *= tr.scaled(s).mean_factor()
        if self.neighbor is not None:
            slowdown *= self.neighbor.scaled(s).mean_factor()
        return ChaosCostModel(expected_attempts=attempts, slowdown=slowdown,
                              billing_inflation=billing_inflation,
                              timeout_burn_rate=burn,
                              retryable_rate=p_retry)


@dataclass(frozen=True)
class ChaosCostModel:
    """What a chaos scenario does to a plan's price, in expectation."""
    expected_attempts: float = 1.0      # attempts per planned invocation
    slowdown: float = 1.0               # mean duration multiplier
    billing_inflation: float = 1.0      # mean billing-anomaly multiplier
    timeout_burn_rate: float = 0.0      # full-timeout burns per attempt
    retryable_rate: float = 0.0


def moderate_chaos(seed: int = 0) -> ChaosConfig:
    """The 'moderate' scenario of the chaos_robustness table at
    intensity 1: every fault kind plus all four non-stationary regimes.
    Discrete fault rates sit in the few-percent range the SeBS /
    continuous-benchmarking literature reports for real providers;
    noisy-neighbor bursts cover a large fraction of instance-time (CPU
    steal is the dominant real-world interference), with per-timing hits
    so roughly a fifth of duet pairs carry an asymmetric outlier."""
    return ChaosConfig(
        intensity=1.0,
        seed=seed,
        faults=(
            FaultSpec(LOSS, rate=0.02),
            FaultSpec(TIMEOUT_STORM, rate=0.25,
                      period_s=1800.0, window_s=120.0),
            FaultSpec(DUPLICATE, rate=0.03, magnitude=1),
            FaultSpec(ZOMBIE, rate=0.02),
            FaultSpec(BILLING, rate=0.02, magnitude=2.0),
        ),
        traces=(
            DiurnalTrace(amplitude=0.08, period_s=14400.0),
            RegionTrace(n_regions=4, sigma=0.06, seed=seed),
            ColdSpikeTrace(multiplier=3.0, period_s=3600.0, window_s=240.0),
        ),
        neighbor=NoisyNeighborTrace(burst_prob=0.9, epoch_s=600.0,
                                    mean_burst_s=300.0, slowdown=3.5,
                                    seed=seed),
        neighbor_hit=0.35,
        neighbor_sigma=0.5,
    )


class ChaosBackend:
    """Wraps a virtual-time backend with a seeded chaos scenario.

    Duck-types the backend protocol; unknown attributes (``pinned``,
    ``profile``, ``workloads``, router methods, ...) pass through to the
    wrapped backend, so the wrapper composes with every engine feature
    and with the service scheduler's per-job router.
    """

    def __init__(self, inner, cfg: ChaosConfig):
        if getattr(inner, "realtime", False):
            raise ValueError("ChaosBackend wraps virtual-time backends "
                             "only (realtime backends execute on host "
                             "threads)")
        self.inner = inner
        self.cfg = cfg
        self._active = cfg.active
        self._traces = tuple(tr.scaled(cfg.intensity) for tr in cfg.traces)
        self._neighbor = (cfg.neighbor.scaled(cfg.intensity)
                          if cfg.neighbor is not None else None)
        self._rates = {f.kind: min(1.0, f.rate * cfg.intensity)
                       for f in cfg.faults}
        self._specs = {f.kind: f for f in cfg.faults}
        self._seed = cfg.seed & 0x7FFFFFFF
        self.stats: Dict[str, int] = {}
        self._attempt: Dict[tuple, int] = {}
        # armed zombies, keyed by *object* identity (pinned by the value
        # so a freed id can never alias a new instance): iid strings
        # collide across the service router's per-job backends, and the
        # set must survive begin_run — a fleet's warm pool persists
        # across job batches, so a corpse armed at the end of one job
        # must still be dead when the next job acquires it
        self._dead: Dict[int, Instance] = {}
        self._bill_mult: List[float] = []
        self._storm_win = -1             # burst detection (observability)
        self._storm_hits = 0
        # ground truth for detector evaluation: per (fault key, coarse
        # window) span of injected-fault timestamps.  Pure bookkeeping on
        # already-decided faults — no RNG, survives begin_run so a whole
        # scenario accumulates one truth log
        self._truth: Dict[tuple, List[float]] = {}

    # unknown attributes (realtime, pinned, keep_alive_s, profile, ...)
    # resolve on the wrapped backend
    def __getattr__(self, name):
        return getattr(self.inner, name)

    # ------------------------------------------------------------ protocol
    def begin_run(self, parallelism: int) -> None:
        self.inner.begin_run(parallelism)
        if self._active:
            self.stats = {}
            self._attempt = {}
            self._bill_mult = []
            # _dead deliberately persists: zombies live as long as the
            # (possibly shared, cross-run) warm pool that holds them

    def spawn_instance(self, inv: Invocation, t: float, slot: int) -> tuple:
        inst, overhead = self.inner.spawn_instance(inv, t, slot)
        if self._active and overhead:
            f = 1.0
            for tr in self._traces:
                f *= tr.cold_factor(t)
            if f != 1.0:
                self._count("cold_spikes", t, inv)
                overhead = overhead * f
        return inst, overhead

    def simulate(self, inv: Invocation, instance: Instance, t: float,
                 overhead_s: float) -> InvocationOutcome:
        if not self._active:
            return self.inner.simulate(inv, instance, t, overhead_s)
        # the wrapped platform always simulates (its RNG stream advances
        # exactly as without faults at this point in the schedule); chaos
        # then overrides what the platform *reports*
        out = self.inner.simulate(inv, instance, t, overhead_s)
        rng = self._inv_rng(inv)
        u = rng.random(_U_BLOCK)
        bill_mult = 1.0
        spec = self._specs.get(BILLING)
        if spec is not None and u[_U_SLOT[BILLING]] < self._rates[BILLING]:
            bill_mult = spec.magnitude
            self._count("billing_anomalies", t, inv)
        self._bill_mult.append(bill_mult)

        ikey = instance_key(instance.iid)
        if id(instance) in self._dead:
            # zombie warm instance: the sandbox died while idle in the
            # pool; the request fails fast and the instance is unusable
            self._count("zombie_hits", t, inv)
            return InvocationOutcome([], 0.05, ok=False,
                                     platform_failure=True,
                                     instance_dead=True)
        if LOSS in self._rates and u[_U_SLOT[LOSS]] < self._rates[LOSS]:
            # the request vanishes before user code runs: nothing billed
            self._count("lost", t, inv)
            return InvocationOutcome([], 0.0, ok=False,
                                     platform_failure=True, lost=True)
        spec = self._specs.get(TIMEOUT_STORM)
        if (spec is not None and spec.in_window(t)
                and u[_U_SLOT[TIMEOUT_STORM]] < self._rates[TIMEOUT_STORM]):
            # the function hangs until its timeout; transient (a retry
            # outside the window succeeds), but the timeout is billed
            self._count("storm_timeouts", t, inv)
            return InvocationOutcome([], inv.timeout_s, ok=False,
                                     timed_out=True, platform_failure=True)

        out = self._apply_regimes(out, inv, instance, t, ikey, rng)

        spec = self._specs.get(ZOMBIE)
        if out.ok and spec is not None and spec.in_window(t) \
                and u[_U_SLOT[ZOMBIE]] < self._rates[ZOMBIE]:
            # the instance dies *after* this successful invocation but
            # stays in the warm pool until someone acquires the corpse
            self._dead[id(instance)] = instance
            self._count("zombies_armed", t, inv)
        spec = self._specs.get(DUPLICATE)
        if (out.ok and spec is not None
                and u[_U_SLOT[DUPLICATE]] < self._rates[DUPLICATE]):
            self._count("duplicates_injected", t, inv)
            out = replace_outcome(out, duplicates=max(1,
                                                      int(spec.magnitude)))
        return out

    def finalize(self, billed_seconds: List[float],
                 wall_seconds: float) -> float:
        if self._active and len(self._bill_mult) == len(billed_seconds):
            # metering anomalies inflate individual bills; the alignment
            # guard mirrors SimFaaSBackend._sim_mem (hedge twins are
            # simulate calls too, so lengths normally match)
            billed_seconds = [b * m for b, m
                              in zip(billed_seconds, self._bill_mult)]
        return self.inner.finalize(billed_seconds, wall_seconds)

    # ------------------------------------------------------------- helpers
    def _count(self, key: str, t: Optional[float] = None,
               inv: Optional[Invocation] = None) -> None:
        """Tally one injected fault; when observability is on, also emit
        a ``chaos.<key>`` instant + counter and trigger flight-recorder
        dumps on anomaly bursts.  Faults are rare events (never the hot
        path), so the context is resolved per call — and only *reads*
        already-decided fault state, never an RNG."""
        self.stats[key] = self.stats.get(key, 0) + 1
        if t is not None:
            # ground-truth log (for detector precision/recall scoring):
            # coarse 60 s buckets, merged into incident windows on read
            w = int(t // 60.0)
            rec = self._truth.get((key, w))
            if rec is None:
                self._truth[(key, w)] = [t, t, 1.0]
            else:
                rec[0] = min(rec[0], t)
                rec[1] = max(rec[1], t)
                rec[2] += 1.0
        from repro_torch.obs import get_obs
        obs = get_obs()
        if obs is None or not obs.enabled:
            return
        prov = getattr(getattr(self.inner, "profile", None), "name",
                       None) or type(self.inner).__name__
        args = {"count": self.stats[key]}
        if inv is not None:
            args["benchmark"] = inv.benchmark
            if inv.job_id:
                args["job"] = inv.job_id
        ts = t if t is not None else 0.0
        obs.tracer.instant(f"chaos.{key}", cat="chaos", ts=ts,
                           pid=f"chaos:{prov}", tid=key, args=args)
        obs.metrics.inc(f"chaos.{key}", provider=prov)
        if obs.recorder is None or t is None:
            return
        if key == "zombie_hits":
            obs.recorder.dump("zombie_hit", ts=t, context=args)
        elif key == "storm_timeouts":
            # a burst = several storm timeouts inside one storm window;
            # dump once per bursting window, not once per timeout
            spec = self._specs.get(TIMEOUT_STORM)
            period = getattr(spec, "period_s", 0.0) if spec else 0.0
            win = int(t // period) if period > 0 else 0
            if win != self._storm_win:
                self._storm_win, self._storm_hits = win, 0
            self._storm_hits += 1
            if self._storm_hits == _STORM_BURST_THRESHOLD:
                obs.recorder.dump(
                    "timeout_storm_burst", ts=t,
                    context={"window": win,
                             "hits": self._storm_hits, **args})

    def ground_truth(self, merge_gap_s: float = 120.0) -> List[dict]:
        """Injected-fault windows, merged per fault kind: the answer key
        a detector run is scored against (precision / recall /
        time-to-detect in benchmarks/obs_bench.py)."""
        by_kind: Dict[str, List[List[float]]] = {}
        for (key, _w), (t0, t1, n) in sorted(self._truth.items(),
                                             key=lambda kv: (kv[0][0],
                                                             kv[1][0])):
            spans = by_kind.setdefault(key, [])
            if spans and t0 - spans[-1][1] <= merge_gap_s:
                spans[-1][1] = max(spans[-1][1], t1)
                spans[-1][2] += n
            else:
                spans.append([t0, t1, n])
        out = []
        for key in sorted(by_kind):
            for t0, t1, n in by_kind[key]:
                out.append({"kind": key, "t0": t0, "t1": t1,
                            "count": int(n)})
        out.sort(key=lambda r: (r["t0"], r["kind"]))
        return out

    def _inv_rng(self, inv: Invocation) -> np.random.Generator:
        """Per-attempt RNG keyed by the invocation's identity: a pure
        function of (seed, job, benchmark, call, attempt) — independent
        of every other invocation's draws."""
        k = (inv.job_id, inv.benchmark, inv.call_index)
        a = self._attempt.get(k, 0)
        self._attempt[k] = a + 1
        ident = zlib.crc32(f"{inv.job_id}:{inv.benchmark}".encode())
        return np.random.default_rng(np.random.SeedSequence(
            [self._seed, _CHAOS_TAG, ident, inv.call_index, a]))

    def _apply_regimes(self, out: InvocationOutcome, inv: Invocation,
                       instance: Instance, t: float, ikey: int,
                       rng: np.random.Generator) -> InvocationOutcome:
        """Scale the reported timings by the active performance regimes.

        Smooth regime factors multiply every timing of the invocation
        identically (they cancel in duet diffs but lengthen durations);
        an active noisy-neighbor burst draws an independent lognormal
        multiplier per *timing*, contaminating the pair's diff.  If a
        scaled timing blows the per-benchmark timeout the invocation is
        reported as a transient timeout (capacity interference, not a
        property of the benchmark)."""
        sym = 1.0
        for tr in self._traces:
            sym *= tr.speed_factor(t, ikey)
        burst = (self._neighbor is not None
                 and self._neighbor.active(t, ikey))
        if burst:
            self._count("burst_invocations", t, inv)
        if sym == 1.0 and not burst:
            return out
        if not out.pairs:
            if sym != 1.0 and out.duration_s > 0:
                return replace_outcome(out, duration_s=out.duration_s * sym)
            return out
        mult = np.full(2 * len(out.pairs), sym)
        if burst:
            # per-timing hits: a burst's interference comes and goes at
            # sub-invocation timescale, so one run of a pair can take the
            # full slowdown while its twin runs clean
            hit = rng.random(len(mult)) < self.cfg.neighbor_hit
            if hit.any():
                mult[hit] *= self._neighbor.slowdown * rng.lognormal(
                    0.0, self.cfg.neighbor_sigma, size=int(hit.sum()))
                self._count("contaminated_invocations", t, inv)
        new_pairs: List[DuetPair] = []
        delta = 0.0
        for i, p in enumerate(out.pairs):
            v1 = p.v1_seconds * float(mult[2 * i])
            v2 = p.v2_seconds * float(mult[2 * i + 1])
            if max(v1, v2) > inv.timeout_s:
                # interference pushed a run over the per-benchmark
                # timeout: transient failure, the timeout is billed
                self._count("regime_timeouts", t, inv)
                return InvocationOutcome([], inv.timeout_s, ok=False,
                                         timed_out=True,
                                         platform_failure=True)
            delta += (v1 - p.v1_seconds) + (v2 - p.v2_seconds)
            new_pairs.append(DuetPair(
                benchmark=p.benchmark, v1_seconds=v1, v2_seconds=v2,
                instance_id=p.instance_id, call_index=p.call_index,
                cold_start=p.cold_start))
        return replace_outcome(out, pairs=new_pairs,
                               duration_s=out.duration_s + delta)


def replace_outcome(out: InvocationOutcome, **kw) -> InvocationOutcome:
    """dataclasses.replace for InvocationOutcome (kept explicit so the
    chaos layer never forgets a field the engine later grows)."""
    base = dict(pairs=out.pairs, duration_s=out.duration_s, ok=out.ok,
                timed_out=out.timed_out,
                platform_failure=out.platform_failure,
                benchmark_failure=out.benchmark_failure,
                lost=out.lost, instance_dead=out.instance_dead,
                duplicates=out.duplicates)
    base.update(kw)
    return InvocationOutcome(**base)
