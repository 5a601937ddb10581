"""Structure-of-arrays execution engine: wave-batched virtual time.

`VectorEngine` is a drop-in for `ExecutionEngine` (same constructor, same
`run(plan, observer=None, *, warm_pool=None, start_s=0.0)` contract, same
`EngineReport`) that replaces the per-event Python dispatch loop with
epoch-batched NumPy processing.  Instead of popping one `(slot_free_time,
slot)` event at a time, it pops a *wave* of the W earliest slot events and
computes slot assignment, warm/cold acquisition, RNG duration draws,
per-timing diurnal drift, timeout cascades, retries, billing, and pair
emission as array ops across the whole wave.

Bit-for-bit conformance
-----------------------
The fast path replays the scalar engine exactly — same RNG stream, same
floating-point operation order, same pool/slot decisions:

* **Draws.**  The scalar backend consumes, per dispatch, one lognormal
  for a cold-start speed plus (net of its internal rewind) one lognormal
  per executed timing.  A single ``rng.lognormal(0.0, sigma_vector)``
  call with the per-draw sigmas flattened across the wave consumes the
  PCG64 stream one ziggurat draw per element in order — bit-identical
  values and stream position to the scalar per-call sequence, computed
  in numpy's C loop with the same libm `exp`.  (``np.exp`` over
  reconstructed ``sigma*z`` would differ in the last ulp on ~5% of
  values — its SIMD path is *not* libm — so reconstruction is avoided.)
* **Speculation.**  How many timings a dispatch executes (timeouts break
  early) determines how many draws it consumes, which shifts every later
  dispatch's draws.  The wave draws a per-benchmark *predicted* count,
  computes all durations, and iterates to a fixpoint: lanes before the
  first misprediction are provably exact, so each round repairs at least
  one prediction and the loop converges in 1-2 rounds in steady state.
* **Waves and validity.**  A wave is only valid while no dispatch in it
  completes at or before a later dispatch's start (that completion would
  have re-entered the slot heap / warm pool first).  The committed prefix
  is the longest valid one; the RNG is rewound to exactly the prefix's
  consumption and the remainder re-runs next wave.
* **Warm pool.**  `_VecPool` mirrors `WarmPool`'s two-heap semantics
  (append-sequence pick order, lazy expiry in both heaps) with a pure
  array sweep; the common steady state — pool draining in lockstep with
  the wave — is detected and vectorized, anything else falls back to an
  exact heap mirror.

Routing
-------
Runs the scalar engine cannot hand over unchanged are delegated to it:
observer-driven runs (adaptive controller, service scheduler — results
must stream causally), shared warm pools, realtime backends, and *active*
chaos wrappers (fault injection draws per-event keyed streams and tracks
zombie instances by object identity).  An inactive `ChaosBackend` is an
exact identity and is unwrapped, so zero-chaos conformance runs exercise
the fast path.  Hedging runs use the wave draws but commit through an
exact per-dispatch walk (the hedge threshold is a running median over
completion order).
"""
from __future__ import annotations

import heapq
import math
from collections import deque
from collections.abc import Sequence as _SequenceABC
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.duet import DuetPair
from repro_torch.core.rmit import Invocation, SuitePlan
from repro_torch.faas.engine import (EngineConfig, EngineReport, ExecutionEngine,
                               Instance, InvocationOutcome, _HedgePolicy)

TWO_PI = 2.0 * math.pi


def _merge_into(rest: np.ndarray, pos: np.ndarray,
                new: np.ndarray) -> np.ndarray:
    """Merge sorted `new` into sorted `rest` at searchsorted positions
    `pos` — np.insert without its per-call Python overhead."""
    n, m = rest.shape[0], new.shape[0]
    out = np.empty(n + m, rest.dtype)
    idx = pos + np.arange(m)
    out[idx] = new
    mask = np.ones(n + m, bool)
    mask[idx] = False
    out[mask] = rest
    return out


def _vector_target(backend):
    """(inner simulated backend, outer backend) when the fast path can run
    `backend`, else (None, backend).  Inactive chaos wrappers are exact
    identities and are unwrapped; active ones delegate to the scalar loop.
    A `_JobRouterBackend` (service fleet) qualifies when every routed
    backend is a plain simulated one sharing the fleet profile."""
    from repro_torch.faas.backends import SimFaaSBackend, VMBackend
    from repro_torch.faas.chaos import ChaosBackend
    inner = backend
    while isinstance(inner, ChaosBackend):
        if inner._active:
            return None, backend
        inner = inner.inner
    if getattr(inner, "is_router", False):
        if all(type(b) is not VMBackend and isinstance(b, SimFaaSBackend)
               and b.profile is inner.profile
               for b in inner.backends.values()):
            return inner, backend
        return None, backend
    if isinstance(inner, (SimFaaSBackend, VMBackend)):
        return inner, backend
    return None, backend


# Scalar-fallback log: every time `VectorEngine.run` hands a run to the
# scalar loop it records why, so callers that *explicitly* asked for the
# fast path (e.g. `repro_torch.cb.cli --engine fast`) can detect and report a
# combination that silently degraded.
_FALLBACKS: List[str] = []


def _note_fallback(reason: str) -> None:
    _FALLBACKS.append(reason)


def reset_fallback_log() -> None:
    del _FALLBACKS[:]


def get_fallback_log() -> List[str]:
    return list(_FALLBACKS)


def _pool_importable(pool) -> bool:
    """True when every pooled instance is one the fast path can re-number
    (engine-spawned "i<N>" ids)."""
    for heap in (pool._busy, pool._ready):
        for ent in heap:
            iid = ent[2].iid
            if not (iid.startswith("i") and iid[1:].isdigit()):
                return False
    return True


class PairSeq(_SequenceABC):
    """Array-backed lazy `Sequence[DuetPair]`.

    The fast path emits pairs as parallel column arrays; materializing a
    million `DuetPair` objects costs more than the whole simulation, so
    the report carries this lazy view instead.  It compares equal to the
    scalar engine's plain list and materializes once on first element
    access (analysis code does `list(pairs)` / iteration)."""

    __slots__ = ("_names", "_prefix", "_bid", "_call", "_iid", "_cold",
                 "_v1", "_v2", "_items")

    def __init__(self, names, prefix, bid, call, iid, cold, v1, v2):
        self._names = names            # bench id -> benchmark name
        self._prefix = prefix          # instance id prefix ("i" / "vm")
        self._bid = bid
        self._call = call
        self._iid = iid
        self._cold = cold
        self._v1 = v1
        self._v2 = v2
        self._items: Optional[List[DuetPair]] = None

    def _materialize(self) -> List[DuetPair]:
        items = self._items
        if items is None:
            pre = self._prefix
            iids = [pre + s for s in map(str, self._iid.tolist())]
            names = list(map(self._names.__getitem__, self._bid.tolist()))
            items = list(map(DuetPair, names, self._v1.tolist(),
                             self._v2.tolist(), iids, self._call.tolist(),
                             self._cold.tolist()))
            self._items = items
        return items

    def __len__(self) -> int:
        return int(self._bid.shape[0])

    def __getitem__(self, i):
        return self._materialize()[i]

    def __iter__(self):
        return iter(self._materialize())

    def __eq__(self, other):
        if isinstance(other, PairSeq):
            other = other._materialize()
        if isinstance(other, list):
            return self._materialize() == other
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    __hash__ = None

    def __add__(self, other):
        return self._materialize() + list(other)

    def __radd__(self, other):
        return list(other) + self._materialize()

    def __repr__(self):
        return f"PairSeq(n={len(self)})"


class _VecPool:
    """Array-backed mirror of `WarmPool` for the wave loop.

    Entries (release time, speed, instance number) live in append order —
    row order *is* the pool's pick-sequence order, preserved across
    compactions.  `sweep` is pure: it computes one wave's warm picks and
    lazy-expiry drops without mutating anything; `apply` commits the
    validated prefix."""

    def __init__(self):
        cap = 1024
        self._t = np.zeros(cap)
        self._speed = np.zeros(cap)
        self._iid = np.zeros(cap, np.int64)
        self._alive = np.zeros(cap, bool)
        self._n = 0
        self._dead = 0
        # cached alive rows sorted by (t, row): maintained incrementally
        # across the prefix-only mutations of the steady state, dropped
        # (None) on compaction / arbitrary kills and rebuilt by argsort
        self._ord: Optional[np.ndarray] = None
        self._ordE: Optional[np.ndarray] = None

    def _room(self, m: int) -> None:
        need = self._n + m
        cap = self._t.shape[0]
        if need <= cap:
            return
        if self._dead > (self._n >> 1):
            keep = np.flatnonzero(self._alive[:self._n])
            k = keep.shape[0]
            self._t[:k] = self._t[keep]
            self._speed[:k] = self._speed[keep]
            self._iid[:k] = self._iid[keep]
            self._alive[:k] = True
            self._alive[k:self._n] = False
            self._n, self._dead = k, 0
            self._ord = self._ordE = None        # rows renumbered
            if self._n + m <= cap:
                return
        while cap < self._n + m:
            cap *= 2
        for name in ("_t", "_speed", "_iid", "_alive"):
            old = getattr(self, name)
            new = np.zeros(cap, old.dtype)
            new[:self._n] = old[:self._n]
            setattr(self, name, new)

    def push_batch(self, t_end, speed, iid) -> None:
        m = int(t_end.shape[0])
        if not m:
            return
        self._room(m)
        n = self._n
        self._t[n:n + m] = t_end
        self._speed[n:n + m] = speed
        self._iid[n:n + m] = iid
        self._alive[n:n + m] = True
        self._n = n + m
        if self._ord is not None:
            # merge the batch into the cached order; new rows sit after
            # existing equal times (side="right") exactly as the stable
            # argsort would place them (all new rows are higher-numbered)
            srt = np.argsort(t_end, kind="stable")
            newt = t_end[srt]
            pos = np.searchsorted(self._ordE, newt, side="right")
            self._ord = _merge_into(self._ord, pos,
                                    np.arange(n, n + m, dtype=np.int64)[srt])
            self._ordE = _merge_into(self._ordE, pos, newt)

    def _alive_order(self):
        if self._ord is not None:
            return self._ord, self._ordE
        rows = np.flatnonzero(self._alive[:self._n])
        if rows.shape[0] == 0:
            return rows, rows.astype(np.float64)
        order = rows[np.argsort(self._t[rows], kind="stable")]
        self._ord, self._ordE = order, self._t[order]
        return order, self._ordE

    def sweep(self, pops: np.ndarray, ka: float):
        """Warm/cold assignment for one wave of ascending pop times.
        Returns (warm mask, picked rows, staged drops [(stage, row)])."""
        W = pops.shape[0]
        warm = np.zeros(W, bool)
        pick = np.full(W, -1, np.int64)
        order, E = self._alive_order()
        ne = order.shape[0]
        # Eager purge: pop times never decrease across waves, so an entry
        # already expired relative to pops[0] can never be acquired again.
        # The scalar WarmPool drops such entries lazily on contact; this
        # pool is engine-private, so purging now is unobservable and keeps
        # _alive_order from re-sorting dead weight every wave.
        if ne:
            cut = int(np.searchsorted(E, pops[0] - ka, side="left"))
            if cut:
                dead_rows = order[:cut]
                self._alive[dead_rows] = False
                self._dead += cut
                order = order[cut:]
                E = E[cut:]
                ne -= cut
                self._ord, self._ordE = order, E
        if ne == 0 or E[0] > pops[-1]:
            return warm, pick, ()
        m = min(W, ne)
        # Forced-diagonal fast path: entry k is the *only* eligible,
        # unexpired candidate at pop k (the steady state: releases drain
        # back in lockstep), so the seq tie-break cannot matter.
        if (bool(np.all(E[:m] <= pops[:m]))
                and bool(np.all(pops[:m] - E[:m] <= ka))
                and (m < 2 or bool(np.all(E[1:m] > pops[:m - 1])))
                and (ne <= m or E[m] > pops[-1])):
            warm[:m] = True
            pick[:m] = order[:m]
            return warm, pick, ()
        return self._sweep_general(pops, ka, order, E)

    def _sweep_general(self, pops, ka, order, E):
        """Exact heap mirror of WarmPool.acquire: busy keyed
        (idle_since, seq), ready keyed (seq,), lazy expiry in both."""
        W = pops.shape[0]
        warm = np.zeros(W, bool)
        pick = np.full(W, -1, np.int64)
        drops: List[Tuple[int, int]] = []
        busy = list(zip(E.tolist(), order.tolist()))
        heapq.heapify(busy)
        ready: List[Tuple[int, float]] = []
        for j in range(W):
            tj = pops[j]
            while busy and busy[0][0] <= tj:
                idle_since, row = heapq.heappop(busy)
                if tj - idle_since > ka:
                    drops.append((j, row))
                    continue
                heapq.heappush(ready, (row, idle_since))
            while ready:
                row, idle_since = heapq.heappop(ready)
                if tj - idle_since > ka:
                    drops.append((j, row))
                    continue
                warm[j] = True
                pick[j] = row
                break
        return warm, pick, drops

    def apply(self, warm, pick, drops, k: int) -> None:
        """Commit the first k dispatches' picks and every drop staged at a
        committed pop (releases are pushed separately, in dispatch order)."""
        if k:
            rows = pick[:k][warm[:k]]
            if rows.shape[0]:
                self._alive[rows] = False
                self._dead += int(rows.shape[0])
                if self._ord is not None:
                    nr = rows.shape[0]
                    # diagonal steady state kills exactly the order prefix
                    if (self._ord.shape[0] >= nr
                            and np.array_equal(rows, self._ord[:nr])):
                        self._ord = self._ord[nr:]
                        self._ordE = self._ordE[nr:]
                    else:
                        self._ord = self._ordE = None
        killed = False
        for stage, row in drops:
            if stage < k:
                self._alive[row] = False
                self._dead += 1
                killed = True
        if killed:
            self._ord = self._ordE = None

    def acquire_one(self, t: float, ka: float) -> int:
        """Single acquire (hedge twins), committed immediately; returns
        the picked entry's row or -1 (caller cold-starts)."""
        order, E = self._alive_order()
        if order.shape[0] == 0:
            return -1
        pops = np.array([t])
        warm, pick, drops = self._sweep_general(pops, ka, order, E)
        self.apply(warm, pick, drops, 1)
        return int(pick[0]) if warm[0] else -1

    def push_one(self, t_end: float, speed: float, iid: int) -> None:
        self.push_batch(np.array([t_end]), np.array([speed]),
                        np.array([iid], np.int64))


class _VecRun:
    """One vectorized virtual-time run (no observer, engine-private pool).

    The run advances in *waves*: pop the W earliest slot events, assign
    warm/cold instances with one pool sweep, draw every dispatch's RNG
    stream in bulk, compute all durations with a per-timing-step array
    loop (the diurnal factor depends on accumulated duration, so steps
    are sequential *within* a dispatch but vectorized *across* the wave),
    then commit the longest prefix the scalar engine would have produced
    identically."""

    def __init__(self, cfg: EngineConfig, target, outer, plan: SuitePlan,
                 start_s: float, *, observer=None, warm_pool=None):
        from repro_torch.faas.backends import VMBackend
        self.cfg = cfg
        self.target = target
        self.outer = outer
        self.plan = plan
        self.start_s = start_s
        self.vm = isinstance(target, VMBackend)
        self.observer = observer
        self.warm_pool = warm_pool
        # multi-job mode: `target` is the service `_JobRouterBackend`;
        # every per-benchmark table becomes per-(job, benchmark) combo and
        # RNG draws segment per job (each job backend owns a private
        # stream, re-seeded by the router's begin_run)
        self.multi = bool(getattr(target, "is_router", False))

    # ------------------------------------------------------------ ingest
    def _ingest(self) -> None:
        from operator import attrgetter
        target, plan = self.target, self.plan
        invs = plan.invocations
        N = self.N = len(invs)
        # Three C-level attribute passes (list(map(attrgetter...)))
        # beat one fused pass + zip(*) transpose: the transpose would
        # allocate N short-lived 3-tuples.
        bseq = list(map(attrgetter("benchmark"), invs))
        vseq = list(map(attrgetter("version_order"), invs))
        cseq = list(map(attrgetter("call_index"), invs))
        # dict.fromkeys dedups in C preserving first-appearance order;
        # map(dict.__getitem__, ...) resolves ids without a Python frame
        # per element — together they replace a per-element genexpr.
        if self.multi:
            # one id per (job, benchmark) combo: jobs route to distinct
            # backends, so the same benchmark name can carry different
            # timing tables (memory maps, start offsets) per job
            jseq = list(map(attrgetter("job_id"), invs))
            kseq = list(zip(jseq, bseq))
            cid_of: Dict[tuple, int] = {
                kk: i for i, kk in enumerate(dict.fromkeys(kseq))}
            self.bid_all = np.fromiter(map(cid_of.__getitem__, kseq),
                                       np.int64, N)
            combos = list(cid_of)
            names = [kk[1] for kk in combos]
        else:
            bid_of: Dict[str, int] = {
                bn: i for i, bn in enumerate(dict.fromkeys(bseq))}
            self.bid_all = np.fromiter(map(bid_of.__getitem__, bseq),
                                       np.int64, N)
            combos = None
            names = list(bid_of)
        pat_of: Dict[tuple, int] = {
            v: i for i, v in enumerate(dict.fromkeys(vseq))}
        self.pid_all = np.fromiter(map(pat_of.__getitem__, vseq),
                                   np.int64, N)
        pats = list(pat_of)
        self.names = names
        self.call_all = np.fromiter(cseq, np.int64, N)
        nP = len(pats)
        Rmax = max((len(p) for p in pats), default=1)
        self.PAT_R = np.fromiter((len(p) for p in pats), np.int64, nP)
        self.PAT_N2 = 2 * self.PAT_R
        self.ISV2 = np.zeros((nP, 2 * Rmax), bool)
        self.V1COL = np.zeros((nP, Rmax), np.int64)
        self.V2COL = np.zeros((nP, Rmax), np.int64)
        for pi, p in enumerate(pats):
            for r, order in enumerate(p):
                for pos, ver in enumerate(order):
                    self.ISV2[pi, 2 * r + pos] = ver == "v2"
                self.V1COL[pi, r] = 2 * r + order.index("v1")
                self.V2COL[pi, r] = 2 * r + order.index("v2")
        # Per-benchmark tables, computed with the *same Python-float
        # expressions* the scalar backend evaluates per call.
        B = len(names)
        if self.multi:
            self.jobs = sorted(target.backends)   # begin_run seeding order
            jidx_of = {j: i for i, j in enumerate(self.jobs)}
            self.bes = [target.backends[j] for j in self.jobs]
            self.cjob = [kk[0] for kk in combos]
            self.combo_jidx = np.fromiter(
                (jidx_of[kk[0]] for kk in combos), np.int64, B)
            bes_c = [target.backends[kk[0]] for kk in combos]
            wls = [be.workloads[kk[1]]
                   for be, kk in zip(bes_c, combos)]
        else:
            self.cjob = [""] * B
            wls = [target.workloads[n] for n in names]
        self.bunst = np.array([w.unstable_pct > 0 for w in wls]) \
            if B else np.zeros(0, bool)
        self.any_unst = bool(self.bunst.any())
        if self.multi:
            p = target.profile
            self.bv1 = np.array([w.true_seconds("v1") for w in wls])
            self.bv2 = np.array([w.true_seconds("v2") for w in wls])
            self.bsig = np.array([w.run_sigma for w in wls])
            self.bfs = np.array([w.fs_write for w in wls]) \
                if B else np.zeros(0, bool)
            self.bov = np.array([p.cold_start_base_s
                                 + p.cold_start_per_gb_s * be.image_gb
                                 + w.setup_seconds
                                 for be, w in zip(bes_c, wls)])
            self.bcpu = np.array([be.cpu_factor if be.memory_map is None
                                  else p.cpu_share(be.memory_for(kk[1]))
                                  for be, kk in zip(bes_c, combos)])
            self.bmem_list = [be.memory_for(kk[1])
                              for be, kk in zip(bes_c, combos)]
            self.any_memmap = any(be.memory_map is not None
                                  for be in self.bes)
            self.bmem = self.bmem_list if self.any_memmap else None
            self.bdstart = np.array([be.start for be in bes_c])
            self.amp = p.diurnal_amplitude
            self.period = p.diurnal_period_s
            self.diur_start = 0.0          # per-lane bdstart applies instead
            self.bt = p.benchmark_timeout_s
            self.ft = p.function_timeout_s
            self.sig_inst = p.instance_sigma
            self.rate = p.failure_rate
            self.seq = self.rate > 0.0
        elif self.vm:
            c = target.cfg
            self.bv1 = np.array([w.true_seconds("v1", env="vm")
                                 for w in wls])
            self.bv2 = np.array([w.true_seconds("v2", env="vm")
                                 for w in wls])
            self.bsig = np.array([w.run_sigma * c.run_sigma_scale
                                  for w in wls])
            self.bfs = np.zeros(B, bool)
            self.dur0 = c.trial_overhead_s
            self.amp = c.diurnal_amplitude
            self.period = 86400.0
            self.diur_start = 0.0
            self.rate = 0.0
            self.sig_inst = 0.0          # pinned fleet: no cold draws
            self.seq = False
            self.bmem = None
        else:
            p = target.profile
            self.bv1 = np.array([w.true_seconds("v1") for w in wls])
            self.bv2 = np.array([w.true_seconds("v2") for w in wls])
            self.bsig = np.array([w.run_sigma for w in wls])
            self.bfs = np.array([w.fs_write for w in wls]) \
                if B else np.zeros(0, bool)
            self.bov = np.array([p.cold_start_base_s
                                 + p.cold_start_per_gb_s * target.image_gb
                                 + w.setup_seconds for w in wls])
            if target.memory_map is None:
                self.bcpu = np.full(B, target.cpu_factor)
                self.bmem = None
            else:
                mems = [target.memory_for(n) for n in names]
                self.bcpu = np.array([p.cpu_share(m) for m in mems])
                self.bmem = mems
            self.amp = p.diurnal_amplitude
            self.period = p.diurnal_period_s
            self.diur_start = target.start
            self.bt = p.benchmark_timeout_s
            self.ft = p.function_timeout_s
            self.sig_inst = p.instance_sigma
            self.rate = p.failure_rate
            self.seq = self.rate > 0.0
        # used-draw predictor per benchmark: -1 = consumes its full 2R
        self.predtab = np.full(B, -1, np.int64)
        self.exec_mask = np.zeros(B, bool)
        self.fail_mask = np.zeros(B, bool)

    # ----------------------------------------------------------- execute
    def execute(self) -> EngineReport:
        cfg = self.cfg
        self.outer.begin_run(cfg.parallelism)
        self._ingest()
        if self.multi:
            # grab the job streams *after* begin_run re-seeded them
            self.rngs = [be._rng for be in self.bes]
            self.ninst_j = np.zeros(len(self.bes), np.int64)
        else:
            self.rng = self.target._rng
        # observability at wave granularity: one span + one bulk metrics
        # flush per wave keeps the vectorized path fast, and everything
        # emitted is read from already-committed arrays (no RNG, no
        # reordering) so reports stay bit-identical with tracing on
        from repro_torch.obs import get_obs
        _obs = get_obs()
        on = _obs is not None and _obs.enabled
        self._tr = _obs.tracer if on else None
        self._mx = _obs.metrics if on else None
        # active monitoring: the windowed engine feed is resolved once
        # here, then each wave bulk-observes into it (same resolve-once
        # contract as tracer/metrics; off = one `is not None` per wave)
        self._mon = _obs.monitor if _obs is not None else None
        self._mfeed = None
        if on or self._mon is not None:
            prof = getattr(self.target, "profile", None)
            self._provider = getattr(prof, "name", None) \
                or type(self.target).__name__
            self._lane = f"fleet:{self._provider}"
            self._wave_idx = 0
            B = len(self.names)
            self._bm_inv = np.zeros(B, np.int64)
            self._bm_billed = np.zeros(B)
            if self._mon is not None:
                self._mfeed = self._mon.engine_feed(self._provider)
        P = cfg.parallelism
        self.slot_t = np.full(P, float(self.start_s))
        if self.vm:
            self.vm_speed = self.target._vm_speed
        else:
            self.pool = _VecPool()
            self.ka = self.target.keep_alive_s
            if self.warm_pool is not None:
                self._import_pool(self.warm_pool)
        self.ninst = 0
        self.skipped = 0
        if self.observer is not None:
            # completed events buffered until the virtual clock reaches
            # them (scalar deliver_due), flushed in (t_end, seq) order
            self.skipmode = bool(self.observer.skip_possible())
            self.evq: List[dict] = []
            self.evn = 0
            self.ev_min = math.inf
            # exact-shadow observers mirror buffered completions, so
            # volatile lanes compose past the delivery horizon whenever
            # the shadow proves the flip lands after their check time
            self.shadow = bool(self.skipmode and self.multi
                               and not self.vm
                               and not cfg.hedge_after_factor > 0
                               and getattr(self.observer,
                                           "skip_exact", False))
        else:
            self.skipmode = False
            self.shadow = False
        self.wall = 0.0
        self.cold_starts = self.timeouts = self.failures = 0
        self.done_n = self.failed_n = self.retries_n = self.hedged = 0
        self.billed_chunks: List[np.ndarray] = []
        self.membid_chunks: List[np.ndarray] = []
        self.pv1c: List[np.ndarray] = []
        self.pv2c: List[np.ndarray] = []
        self.pbidc: List[np.ndarray] = []
        self.pcallc: List[np.ndarray] = []
        self.piidc: List[np.ndarray] = []
        self.pcoldc: List[np.ndarray] = []
        self.cursor = 0
        self.retryq: deque = deque()
        self.walk = cfg.hedge_after_factor > 0
        if self.walk:
            self.hedge = _HedgePolicy(cfg)
            self.billed_list: List[float] = []
            self.mems_list: List[float] = []
            self.pairs_list: List[DuetPair] = []
        self.wcap = min(P, 4096)
        while self.cursor < self.N or self.retryq:
            self._wave()
        if self.observer is not None:
            self._flush_events(math.inf)   # scalar end-of-run drain
        rep = self._report()
        if self.warm_pool is not None and not self.vm:
            self._export_pool(self.warm_pool)
        return rep

    # ---------------------------------------------------- shared warm pool
    def _import_pool(self, wp) -> None:
        """Mirror a shared `WarmPool` into the SoA pool.  Scalar pick
        order is "idle, unexpired entry with the smallest seq"; loading
        rows in seq order makes row order reproduce it exactly (ready
        entries re-enter as busy rows, which is equivalent under the
        pool's non-decreasing-clock contract)."""
        ent = [(seq, t, inst) for (t, seq, inst) in wp._busy]
        ent += [(seq, t, inst) for (seq, t, inst) in wp._ready]
        if not ent:
            return
        ent.sort(key=lambda e: e[0])
        self.pool.push_batch(
            np.array([e[1] for e in ent]),
            np.array([e[2].speed for e in ent]),
            np.array([int(e[2].iid[1:]) for e in ent], np.int64))

    def _export_pool(self, wp) -> None:
        """Write surviving instances back, renumbering seq in row order
        (pick order is preserved, so future acquires behave identically)."""
        rows = np.flatnonzero(self.pool._alive[:self.pool._n])
        t = self.pool._t[rows]
        spd = self.pool._speed[rows]
        iid = self.pool._iid[rows]
        busy = [(float(t[x]), x, Instance("i%d" % int(iid[x]),
                                          float(spd[x])))
                for x in range(rows.shape[0])]
        heapq.heapify(busy)
        wp._busy = busy
        wp._ready = []
        wp._seq = len(busy)

    # --------------------------------------------------- observer delivery
    _EV_FIELDS = ("gidx", "b", "call", "ts", "te", "dur", "att", "ok",
                  "to", "pf", "bf", "cold", "iid", "spd", "cnt")

    def _buffer_events(self, ns, kacc: int, cnt, v1w, v2w) -> None:
        te = ns.push[:kacc]
        chunk = {"gidx": ns.gidx[:kacc], "b": np.asarray(ns.b[:kacc]),
                 "call": np.asarray(ns.call[:kacc]), "ts": ns.pops[:kacc],
                 "te": te, "dur": ns.dur[:kacc], "att": ns.att[:kacc],
                 "ok": ns.okv[:kacc], "to": ns.timedv[:kacc],
                 "pf": ns.platform[:kacc], "bf": ns.benchfail[:kacc],
                 "cold": ns.cold[:kacc], "iid": ns.iidnum[:kacc],
                 "spd": ns.speedw[:kacc], "cnt": cnt,
                 "pv1": v1w, "pv2": v2w}
        self.evq.append(chunk)
        self.evn += kacc
        m = float(te.min())
        if m < self.ev_min:
            self.ev_min = m
        if self.shadow:
            self.observer.skip_shadow(chunk["b"], te, chunk["dur"],
                                      self.names, self.cjob)

    @staticmethod
    def _gather_pairs(pv1, pv2, off, cnt):
        tot = int(cnt.sum())
        if not tot:
            z = np.zeros(0)
            return z, z
        base = np.cumsum(cnt) - cnt
        pos = np.repeat(off - base, cnt) + np.arange(tot)
        return pv1[pos], pv2[pos]

    def _flush_events(self, cutoff: float) -> None:
        """Deliver every buffered completion with t_end <= cutoff as one
        `CompletedWave`, ordered by (t_end, buffer seq) — exactly the
        scalar completion heap's drain order.  Cross-flush order is
        globally consistent: later-buffered events always complete
        strictly after every already-flushed cutoff."""
        if not self.evn or self.ev_min > cutoff:
            return
        from repro_torch.faas.engine import CompletedWave
        q = self.evq
        if len(q) > 1:
            cat = {f: np.concatenate([c[f] for c in q])
                   for f in self._EV_FIELDS}
            pv1 = np.concatenate([c["pv1"] for c in q])
            pv2 = np.concatenate([c["pv2"] for c in q])
        else:
            cat = q[0]
            pv1, pv2 = cat["pv1"], cat["pv2"]
        te = cat["te"]
        due = te <= cutoff
        di = np.flatnonzero(due)
        order = di[np.argsort(te[di], kind="stable")]
        cnt = cat["cnt"]
        off = np.cumsum(cnt) - cnt
        scnt = cnt[order]
        w1, w2 = self._gather_pairs(pv1, pv2, off[order], scnt)
        wave = CompletedWave(
            n=int(order.shape[0]), plan_invocations=self.plan.invocations,
            gidx=cat["gidx"][order], combo=cat["b"][order],
            combo_bench=self.names, combo_job=self.cjob,
            call=cat["call"][order], t_start=cat["ts"][order],
            t_end=te[order], duration_s=cat["dur"][order],
            attempt=cat["att"][order], ok=cat["ok"][order],
            timed_out=cat["to"][order],
            platform_failure=cat["pf"][order],
            benchmark_failure=cat["bf"][order], cold=cat["cold"][order],
            iid_num=cat["iid"][order], speed=cat["spd"][order],
            iid_prefix="vm" if self.vm else "i",
            pair_off=np.cumsum(scnt) - scnt, pair_cnt=scnt,
            pair_v1=w1, pair_v2=w2)
        keep = np.flatnonzero(~due)
        if keep.shape[0]:
            rv1, rv2 = self._gather_pairs(pv1, pv2, off[keep], cnt[keep])
            rem = {f: cat[f][keep] for f in self._EV_FIELDS}
            rem["pv1"], rem["pv2"] = rv1, rv2
            self.evq = [rem]
            self.evn = int(keep.shape[0])
            self.ev_min = float(rem["te"].min())
        else:
            self.evq = []
            self.evn = 0
            self.ev_min = math.inf
        self.observer.on_wave(wave)

    # -------------------------------------------------------------- wave
    def _wave(self) -> None:
        ns = self._compose()
        if ns.W == 0:
            # the whole scanned front was cancelled work: no dispatches,
            # just committed skips
            self._commit_skips(ns, ns.scan_end)
            self.cursor += ns.scan_end
            return
        self._fixpoint(ns)
        k = self._validity(ns)
        if self.walk:
            self._walk(ns, k)
            return
        k, retried = self._retry_truncate(ns, k)
        self._commit_state(ns, k, retried)
        self._tally_fast(ns, k, retried)
        # track the commit rate closely: every composed-but-uncommitted
        # lane is drawn, staged, rewound, and re-drawn next wave, so at
        # low commit rates (dense completion/pop interleaving, e.g. the
        # multi-tenant fleet in steady state) a high floor multiplies
        # the speculative waste
        self.wcap = min(self.cfg.parallelism, max(8, int(k * 1.5) + 4))

    def _compose(self):
        if self.observer is not None and self.skipmode:
            # scalar deliver_due before the wave's first dispatch: flush
            # everything completed by the earliest slot's free time, so
            # the observer's state is current for the skip previews.
            # Without live skips, delivery never feeds back into
            # scheduling, so flushes defer to one end-of-run wave
            # (later-buffered events always complete after every earlier
            # cutoff, so the concatenated order is unchanged).
            cutoff = float(self.slot_t.min()) if (self.vm or self.walk) \
                else float(self.slot_t[0])
            self._flush_events(cutoff)
            return self._compose_skip()
        nr = len(self.retryq)
        W = min(self.wcap, nr + (self.N - self.cursor))
        if nr:
            m = min(nr, W)
            g1 = np.fromiter((self.retryq[i][0] for i in range(m)),
                             np.int64, m)
            a1 = np.fromiter((self.retryq[i][1] for i in range(m)),
                             np.int64, m)
            rest = W - m
            gidx = np.concatenate(
                [g1, np.arange(self.cursor, self.cursor + rest)])
            att = np.concatenate([a1, np.zeros(rest, np.int64)])
            b = self.bid_all[gidx]
            pidw = self.pid_all[gidx]
            call = self.call_all[gidx]
        else:
            c = self.cursor
            gidx = np.arange(c, c + W)
            att = np.zeros(W, np.int64)
            b = self.bid_all[c:c + W]               # contiguous: view
            pidw = self.pid_all[c:c + W]
            call = self.call_all[c:c + W]
        return self._build_ns(W, nr, gidx, att, b, pidw, call, None, 0, ())

    def _compose_skip(self):
        """Wave composition with live skip decisions (budget preemption).

        `peek_skip` is consulted speculatively while scanning the queue
        front; real `should_skip` replays at commit for exactly the
        skips the committed prefix consumed.  A lane whose preview can
        still flip with future deliveries (`skip_volatile`) is only
        composed while no buffered completion is due at its scalar
        check time st[j] — the observer's state is then frozen up to
        that horizon, so the preview equals the scalar decision.
        Non-volatile lanes compose past the horizon: a constant-False
        answer cannot change, and a True answer is monotone by the
        wave-eligibility contract.  Trailing cancelled entries past the
        last lane are safe to consume for the same reason.

        With an exact-shadow observer (`skip_exact`), a volatile lane
        also composes past the horizon whenever `skip_flip_s` proves
        the flip lands strictly after st[j]: buffered deliveries up to
        st[j] cannot flip it, and completions of lanes composed earlier
        in this wave cannot land by st[j] inside the committed prefix
        (`_validity` truncates the wave at the first such crossing), so
        the False preview equals the scalar decision.  When the flip
        lands at or before st[j] the wave still breaks: the flip is
        delivered for real by the next compose-time flush and the entry
        consumed as an ordinary skip then."""
        obs = self.observer
        invs = self.plan.invocations
        st = self.slot_t                  # sorted (elastic, non-walk)
        P = st.shape[0]
        bmin = self.ev_min                # inf when the buffer is empty
        nr = len(self.retryq)
        cap = min(self.wcap, nr + (self.N - self.cursor))
        gl: List[int] = []
        al: List[int] = []
        qp: List[int] = []
        skips: List[int] = []
        j = 0
        i = 0
        while i < nr and j < cap and bmin > st[j]:
            gl.append(self.retryq[i][0])
            al.append(self.retryq[i][1])
            qp.append(-1)
            i += 1
            j += 1
        pos = 0
        scan_end = 0
        c = self.cursor
        if i == nr:
            nq = self.N - c
            while pos < nq and j < cap:
                inv = invs[c + pos]
                if obs.peek_skip(inv):
                    skips.append(pos)
                    pos += 1
                    continue
                if (bmin <= st[j] and obs.skip_volatile(inv)
                        and (not self.shadow
                             or obs.skip_flip_s(inv) <= st[j])):
                    break
                gl.append(c + pos)
                al.append(0)
                qp.append(pos)
                pos += 1
                j += 1
            while pos < nq and j < P and bmin > st[j] \
                    and obs.peek_skip(invs[c + pos]):
                skips.append(pos)
                pos += 1
            scan_end = pos
        W = j
        if W == 0:
            return SimpleNamespace(W=0, nr=0, scan_end=scan_end,
                                   skip_offsets=skips, lane_qpos=None)
        gidx = np.fromiter(gl, np.int64, W)
        att = np.fromiter(al, np.int64, W)
        return self._build_ns(W, i, gidx, att, self.bid_all[gidx],
                              self.pid_all[gidx], self.call_all[gidx],
                              np.fromiter(qp, np.int64, W), scan_end,
                              skips)

    def _build_ns(self, W, nr, gidx, att, b, pidw, call,
                  lane_qpos, scan_end, skip_offsets):
        ns = SimpleNamespace(
            W=W, nr=nr, gidx=gidx, att=att, b=b, pidw=pidw,
            call=call, Rw=self.PAT_R[pidw],
            n2w=self.PAT_N2[pidw], lane_qpos=lane_qpos,
            scan_end=scan_end, skip_offsets=skip_offsets,
            jw=self.combo_jidx[b] if self.multi else None)
        speedw = np.zeros(W)
        if self.vm:
            order = np.lexsort((np.arange(self.slot_t.shape[0]),
                                self.slot_t))[:W]
            ns.slot_of = order
            ns.pops = self.slot_t[order].copy()
            ns.warm = np.zeros(W, bool)
            ns.cold = np.zeros(W, bool)
            ns.cold_before = np.zeros(W, np.int64)
            ns.pick = None
            ns.drops = ()
            speedw[:] = self.vm_speed[order]
            ns.iidnum = order.astype(np.int64)
        else:
            # Elastic platforms erase slot identity (a slot is just a free
            # time), so outside walk mode slot_t is *maintained* sorted;
            # walk mode mutates slots positionally (hedge twins) and
            # re-sorts here.
            st = np.sort(self.slot_t) if self.walk else self.slot_t
            ns.slot_sorted = st
            ns.pops = st[:W].copy()
            warm, pick, drops = self.pool.sweep(ns.pops, self.ka)
            ns.warm, ns.pick, ns.drops = warm, pick, drops
            ns.cold = ~warm
            if warm.any():
                speedw[warm] = self.pool._speed[pick[warm]]
            if warm.all():
                ns.iidnum = self.pool._iid[pick]
                ns.cold_before = np.zeros(W, np.int64)
            elif self.multi:
                # per-job cold ranks: each backend numbers its own
                # instances, so a lane's id is its job's running count
                # plus its cold rank among this wave's same-job lanes
                jw = ns.jw
                cold64 = ns.cold.astype(np.int64)
                order = np.argsort(jw, kind="stable")
                cg = cold64[order]
                cs = np.cumsum(cg)
                jo = jw[order]
                seg_off = np.zeros(W, np.int64)
                if W > 1:
                    seg_off[1:] = np.maximum.accumulate(
                        np.where(jo[1:] != jo[:-1], cs[:-1], 0))
                cb = np.empty(W, np.int64)
                cb[order] = cs - seg_off - cg
                ns.iidnum = np.where(
                    ns.cold, self.ninst_j[jw] + cb + 1,
                    self.pool._iid[pick]).astype(np.int64)
                ns.cold_before = cb
            else:
                cold_cum = np.cumsum(ns.cold)
                ns.iidnum = np.where(ns.cold, self.ninst + cold_cum,
                                     self.pool._iid[pick]).astype(np.int64)
                ns.cold_before = cold_cum - ns.cold
        ns.speedw = speedw
        ns.unst = self.bunst[b]
        ns.fsl = self.bfs[b]
        ns.sigl = self.bsig[b]
        ns.n2maxw = int(ns.n2w.max()) if W else 0
        return ns

    def _fixpoint(self, ns) -> None:
        """Iterate speculative draw counts to the scalar fixpoint: lanes
        before the first misprediction consume a provably correct draw
        prefix, so pinning each lane's next-round count to its observed
        usage converges (typically in 1-2 rounds)."""
        W = ns.W
        pw = self.predtab[ns.b]
        npred = np.where(pw < 0, ns.n2w, np.minimum(pw, ns.n2w))
        norm = ~ns.unst & ~ns.fsl
        npred = np.where(norm, npred, 0)
        self._save_states(ns)
        iters = 0
        while True:
            iters += 1
            if iters > 1:                 # already positioned on entry
                self._restore_states(ns)
            if self.seq:
                failp, unst_outs = self._draws_seq(ns, npred)
            else:
                failp, unst_outs = self._draws_fast(ns, npred)
            self._stages(ns, npred, failp, unst_outs)
            acct = norm & ~failp
            npred_eff = np.where(acct, npred, 0)
            mism = ((ns.used != npred_eff) | ns.starv) & acct
            if not mism.any():
                break
            if iters > 2 * W + 10:
                raise RuntimeError("vector engine draw fixpoint diverged")
            npred = np.where(ns.starv, ns.n2w, ns.used)
            npred = np.where(norm, npred, 0)
        ns.failp = failp
        ns.unst_outs = unst_outs
        ns.used_final = np.where(norm & ~failp, ns.used, 0)
        # seed future waves' speculation
        ln = np.flatnonzero(norm & ~failp)
        if ln.shape[0]:
            self.predtab[ns.b[ln]] = np.where(
                ns.used[ln] == ns.n2w[ln], -1, ns.used[ln])

    def _save_states(self, ns) -> None:
        if self.multi:
            # only the jobs present in this wave consume draws
            ns.states0 = [(int(j), self.rngs[j].bit_generator.state)
                          for j in np.unique(ns.jw).tolist()]
        else:
            ns.state0 = self.rng.bit_generator.state

    def _restore_states(self, ns) -> None:
        if self.multi:
            for j, stt in ns.states0:
                self.rngs[j].bit_generator.state = stt
        else:
            self.rng.bit_generator.state = ns.state0

    def _validity(self, ns) -> int:
        """Longest prefix in which no dispatch completes at or before a
        later dispatch's pop (such a completion would have re-entered
        the slot heap and warm pool first in the scalar order)."""
        W = ns.W
        ns.push = ns.pops + ns.dur
        if W > 1:
            pmin = np.minimum.accumulate(ns.push)
            bad = pmin[:W - 1] <= ns.pops[1:]
            if bad.any():
                return int(np.argmax(bad)) + 1
        return W

    def _retry_truncate(self, ns, k: int):
        """Scalar retry semantics: a retried platform failure re-enters
        at the *front* of the queue, so the wave must cut right after the
        first retryable failure."""
        if self.seq and self.cfg.max_retries > 0:
            retr = ns.failp & (ns.att < self.cfg.max_retries)
            if retr.any():
                fr = int(np.argmax(retr))
                if fr < k:
                    return fr + 1, True
        return k, False

    # -------------------------------------------------------------- draws
    def _sim_direct(self, ns, u: int):
        """Run one dispatch through the real backend (unstable-noise lanes
        interleave uniform draws the batch reconstruction cannot mimic);
        returns (outcome, instance_speed).  Idempotent across fixpoint
        re-runs: the RNG is positioned by the caller and the instance
        counter is pinned before every spawn."""
        target = self.target
        inv = self.plan.invocations[int(ns.gidx[u])]
        t = float(ns.pops[u])
        if self.vm:
            inst = Instance("vm%d" % int(ns.iidnum[u]), float(ns.speedw[u]))
            return target.simulate(inv, inst, t, 0.0), inst.speed
        if self.multi:
            # bypass the router: draws must come from the lane's own job
            # stream, and the counter pin must hit that job's backend
            target = self.bes[int(ns.jw[u])]
        if ns.cold[u]:
            if self.multi:
                target._inst_counter = (int(self.ninst_j[int(ns.jw[u])])
                                        + int(ns.cold_before[u]))
            else:
                target._inst_counter = self.ninst + int(ns.cold_before[u])
            inst, ov = target.spawn_instance(inv, t, 0)
            return target.simulate(inv, inst, t, ov), inst.speed
        inst = Instance("i%d" % int(ns.iidnum[u]), float(ns.speedw[u]))
        return target.simulate(inv, inst, t, 0.0), inst.speed

    def _draws_fast(self, ns, npred):
        """No platform failures: every non-unstable dispatch's stream is
        cold?1:0 + npred lognormals — one array-sigma lognormal fill per
        segment between unstable lanes is value- and stream-identical to
        the scalar per-call sequence."""
        if self.multi:
            return self._draws_fast_multi(ns, npred)
        rng = self.rng
        W = ns.W
        cold = ns.cold
        Nmat = np.zeros((W, ns.n2maxw))
        ns.Nmat = Nmat
        if (not self.any_unst and not cold.any() and W
                and bool((npred == npred[0]).all())):
            # homogeneous steady state: all-warm wave, uniform draw count
            npc = int(npred[0])
            if npc:
                vals = rng.lognormal(0.0, np.repeat(ns.sigl, npc))
                Nmat[:, :npc] = vals.reshape(W, npc)
            return np.zeros(W, bool), []
        cnt = np.where(ns.unst, 0, cold.astype(np.int64) + npred)
        off = np.zeros(W + 1, np.int64)
        np.cumsum(cnt, out=off[1:])
        total = int(off[W])
        unst_outs: List[Tuple[int, InvocationOutcome]] = []
        ui = np.flatnonzero(ns.unst)
        if total:
            d_of = np.repeat(np.arange(W), cnt)
            posa = np.arange(total)
            start_of = off[:W]
            iscold = (posa == start_of[d_of]) & cold[d_of]
            sig_flat = np.where(iscold, self.sig_inst, ns.sigl[d_of])
        if ui.shape[0] == 0:
            vals = rng.lognormal(0.0, sig_flat) if total else None
        else:
            vals = np.empty(total)
            a = 0
            for u in ui.tolist():
                lo, hi = int(off[a]), int(off[u])
                if hi > lo:
                    vals[lo:hi] = rng.lognormal(0.0, sig_flat[lo:hi])
                out, spd = self._sim_direct(ns, u)
                ns.speedw[u] = spd
                unst_outs.append((u, out))
                a = u + 1
            lo = int(off[a])
            if total > lo:
                vals[lo:total] = rng.lognormal(0.0, sig_flat[lo:total])
        if total:
            cm = cold & ~ns.unst
            if cm.any():
                ns.speedw[cm] = vals[start_of[cm]]
            nmask = ~iscold
            rows = d_of[nmask]
            cols = posa[nmask] - (start_of + cold)[rows]
            Nmat[rows, cols] = vals[nmask]
        return np.zeros(W, bool), unst_outs

    @staticmethod
    def _fill_run(rng, lanes, cnt, start_of, sig_flat, vals):
        """One array-sigma lognormal fill for a run of same-job lanes:
        gather the lanes' draw slices in lane order, draw once, scatter.
        Single-lane runs (the common case on a many-tenant fleet, where
        waves interleave jobs almost perfectly) take a contiguous-slice
        shortcut — each lane's draws are adjacent in the wave layout."""
        if lanes.shape[0] == 1:
            u = int(lanes[0])
            lo = int(start_of[u])
            hi = lo + int(cnt[u])
            if hi > lo:
                vals[lo:hi] = rng.lognormal(0.0, sig_flat[lo:hi])
            return
        c = cnt[lanes]
        tot = int(c.sum())
        if not tot:
            return
        base = np.cumsum(c) - c
        pos = np.repeat(start_of[lanes] - base, c) + np.arange(tot)
        vals[pos] = rng.lognormal(0.0, sig_flat[pos])

    def _draws_fast_multi(self, ns, npred):
        """Fast draws across routed jobs: each job backend owns a private
        stream, so the scalar's per-dispatch interleaving across jobs is
        irrelevant — grouping each job's lanes (in lane order, which is
        that stream's consumption order) replays every stream exactly.
        Unstable lanes split their job's fill just like the single-job
        path splits the global one."""
        W = ns.W
        cold = ns.cold
        Nmat = np.zeros((W, ns.n2maxw))
        ns.Nmat = Nmat
        cnt = np.where(ns.unst, 0, cold.astype(np.int64) + npred)
        off = np.zeros(W + 1, np.int64)
        np.cumsum(cnt, out=off[1:])
        total = int(off[W])
        start_of = off[:W]
        vals = np.empty(total)
        d_of = np.repeat(np.arange(W), cnt)
        posa = np.arange(total)
        iscold = (posa == start_of[d_of]) & cold[d_of]
        sig_flat = np.where(iscold, self.sig_inst, ns.sigl[d_of])
        unst_outs: List[Tuple[int, InvocationOutcome]] = []
        jw = ns.jw
        order = np.argsort(jw, kind="stable")
        jo = jw[order]
        edges = [0] + (np.flatnonzero(np.diff(jo)) + 1).tolist() + [W]
        for s, e in zip(edges[:-1], edges[1:]):
            grp = order[s:e]
            rng = self.rngs[int(jw[grp[0]])]
            a = 0
            for gi, u in enumerate(grp.tolist()):
                if not ns.unst[u]:
                    continue
                self._fill_run(rng, grp[a:gi], cnt, start_of, sig_flat,
                               vals)
                out, spd = self._sim_direct(ns, u)
                ns.speedw[u] = spd
                unst_outs.append((u, out))
                a = gi + 1
            self._fill_run(rng, grp[a:], cnt, start_of, sig_flat, vals)
        if total:
            cm = cold & ~ns.unst
            if cm.any():
                ns.speedw[cm] = vals[start_of[cm]]
            nmask = ~iscold
            rows = d_of[nmask]
            cols = posa[nmask] - (start_of + cold)[rows]
            Nmat[rows, cols] = vals[nmask]
        return np.zeros(W, bool), unst_outs

    def _draws_seq(self, ns, npred):
        """failure_rate > 0: every dispatch draws a uniform between its
        cold lognormal and its noise vector, so the stream is walked
        per-dispatch (values land in arrays; the stage math stays batched)."""
        W = ns.W
        Nmat = np.zeros((W, ns.n2maxw))
        ns.Nmat = Nmat
        failp = np.zeros(W, bool)
        unst_outs: List[Tuple[int, InvocationOutcome]] = []
        rate = self.rate
        sig_i = self.sig_inst
        multi = self.multi
        if multi:
            jwl = ns.jw.tolist()
            rngs = self.rngs
        else:
            rng = self.rng
            lognormal = rng.lognormal
            random = rng.random
        coldl = ns.cold.tolist()
        unstl = ns.unst.tolist()
        fsll = ns.fsl.tolist()
        sigll = ns.sigl.tolist()
        npl = npred.tolist()
        for j in range(W):
            if multi:
                r = rngs[jwl[j]]
                lognormal = r.lognormal
                random = r.random
            if unstl[j]:
                out, spd = self._sim_direct(ns, j)
                ns.speedw[j] = spd
                unst_outs.append((j, out))
                continue
            if coldl[j]:
                ns.speedw[j] = float(lognormal(0.0, sig_i))
            if float(random()) < rate:
                failp[j] = True
                continue
            if fsll[j]:
                continue
            n = npl[j]
            if n:
                Nmat[j, :n] = lognormal(0.0, sigll[j], size=n)
        return failp, unst_outs

    # ------------------------------------------------------------- stages
    def _stages(self, ns, npred, failp, unst_outs) -> None:
        """Timing step k across the wave: ufunc sequence copied from the
        scalar backend so every float op associates identically."""
        W = ns.W
        vm = self.vm
        b = ns.b
        if vm:
            dur = np.full(W, self.dur0)
        else:
            dur = np.where(ns.cold, self.bov[b], 0.0)
        norm = ~ns.unst & ~ns.fsl & ~failp
        okv = norm.copy()
        timedv = np.zeros(W, bool)
        used = np.zeros(W, np.int64)
        starv = np.zeros(W, bool)
        alive = norm.copy()
        SECS = np.zeros((W, ns.n2maxw))
        ts1 = self.bv1[b]
        ts2 = self.bv2[b]
        speedw = ns.speedw
        if not vm:
            cpul = self.bcpu[b]
        amp, period = self.amp, self.period
        # per-lane diurnal start in multi mode (each job backend carries
        # its own submission-time offset); elementwise add is the same
        # binary op the scalar `start + t` performs per call
        dstart = self.bdstart[b] if self.multi else self.diur_start
        pops, Nmat, n2w = ns.pops, ns.Nmat, ns.n2w
        n2maxw = ns.n2maxw
        isv2w = self.ISV2[ns.pidw, :n2maxw] if n2maxw else None
        # Bulk prefactor: step k's timing is ((ts*N)*speed)*f (/cpu); the
        # first three factors don't depend on accumulated duration, so
        # they collapse into one (W, n2max) product before the loop.
        # In-place ufuncs reorder only commutative float ops (a+b / a*b
        # are bit-commutative in IEEE-754), so every value matches the
        # scalar backend's expression order exactly.
        if n2maxw:
            Q = np.where(isv2w, ts2[:, None], ts1[:, None])
            Q *= Nmat
            Q *= speedw[:, None]
        anydry = bool((npred < n2w).any())
        # With one repeat count across the wave (the common plan shape),
        # act is alive itself: the strips below apply the same masks to
        # both, so aliasing is safe and saves two ufuncs per step.
        n2const = bool((n2w == n2maxw).all())
        # Steady state: every lane survives every step, so the where=
        # masks are all-True and the masked adds collapse to plain
        # ufuncs (same binary op per element — bit-identical).
        aall = n2const and not anydry and bool(alive.all())
        for k in range(n2maxw):
            if aall:
                act = alive
            else:
                act = alive if n2const else alive & (n2w > k)
                if not act.any():
                    break
                if anydry:
                    dry = act & (npred <= k)
                    if dry.any():
                        starv |= dry
                        alive &= ~dry
                        act &= ~dry
                        if not act.any():
                            break
            x = pops + dur
            if not vm:
                x += dstart
            x *= TWO_PI
            x /= period
            np.sin(x, out=x)
            x *= amp
            x += 1.0
            x *= Q[:, k]
            secs = x
            if not vm:
                secs /= cpul
            if aall:
                used += 1
            else:
                used += act
            SECS[:, k] = secs
            if vm:
                if aall:
                    dur += secs
                else:
                    np.add(dur, secs, out=dur, where=act)
                continue
            to = act & (secs > self.bt)
            if to.any():
                aall = False
                timedv |= to
                okv &= ~to
                alive &= ~to
                act &= ~to
                np.add(dur, self.bt, out=dur, where=to)
            if aall:
                dur += secs
            else:
                np.add(dur, secs, out=dur, where=act)
            if k & 1:
                over = act & (dur > self.ft)
                if over.any():
                    aall = False
                    okv &= ~over
                    alive &= ~over
        platform = failp.copy()
        benchfail = np.zeros(W, bool)
        if not vm:
            fsv = ns.fsl & ~failp & ~ns.unst
            if fsv.any():
                dur = np.where(fsv, dur + 0.1, dur)
                benchfail |= fsv
            if failp.any():
                dur = np.where(failp, dur + 0.05, dur)
        idx = np.arange(W)[:, None]
        V1S = SECS[idx, self.V1COL[ns.pidw]]
        V2S = SECS[idx, self.V2COL[ns.pidw]]
        for u, out in unst_outs:
            dur[u] = out.duration_s
            okv[u] = out.ok
            timedv[u] = out.timed_out
            platform[u] = out.platform_failure
            benchfail[u] = out.benchmark_failure
            if out.ok:
                for r, pr in enumerate(out.pairs):
                    V1S[u, r] = pr.v1_seconds
                    V2S[u, r] = pr.v2_seconds
        ns.dur, ns.okv, ns.timedv = dur, okv, timedv
        ns.used, ns.starv = used, starv
        ns.platform, ns.benchfail = platform, benchfail
        ns.V1S, ns.V2S = V1S, V2S

    # ------------------------------------------------------------- commit
    def _rewind_prefix(self, ns, k: int) -> None:
        """Reposition the RNG(s) to exactly the committed prefix's
        consumption (the wave drew for all W lanes)."""
        self._restore_states(ns)
        used = ns.used_final
        unst = ns.unst
        cold = ns.cold
        if not self.seq:
            cnt = np.where(unst[:k], 0,
                           cold[:k].astype(np.int64) + used[:k])
            if self.multi:
                # advance each wave job's stream by its committed lanes'
                # consumption, in lane order (one ziggurat normal per
                # lognormal, so standard_normal(seg) lands exactly)
                jw = ns.jw[:k]
                order = np.argsort(jw, kind="stable")
                jo = jw[order]
                edges = [0] + (np.flatnonzero(np.diff(jo)) + 1).tolist() \
                    + [k]
                for s, e in zip(edges[:-1], edges[1:]):
                    grp = order[s:e]
                    rng = self.rngs[int(jw[grp[0]])]
                    a = 0
                    for gi, u in enumerate(grp.tolist()):
                        if not unst[u]:
                            continue
                        seg = int(cnt[grp[a:gi]].sum())
                        if seg:
                            rng.standard_normal(seg)
                        self._sim_direct(ns, u)
                        a = gi + 1
                    seg = int(cnt[grp[a:]].sum())
                    if seg:
                        rng.standard_normal(seg)
                return
            rng = self.rng
            a = 0
            for u in np.flatnonzero(unst[:k]).tolist():
                seg = int(cnt[a:u].sum())
                if seg:
                    rng.standard_normal(seg)
                self._sim_direct(ns, u)
                a = u + 1
            seg = int(cnt[a:k].sum())
            if seg:
                rng.standard_normal(seg)
            return
        if self.multi:
            jwl = ns.jw.tolist()
            rngs = self.rngs
        else:
            rng = self.rng
            lognormal = rng.lognormal
            random = rng.random
        for j in range(k):
            if self.multi:
                r = rngs[jwl[j]]
                lognormal = r.lognormal
                random = r.random
            if unst[j]:
                self._sim_direct(ns, j)
                continue
            if cold[j]:
                lognormal(0.0, self.sig_inst)
            random()
            if ns.failp[j] or ns.fsl[j]:
                continue
            n = int(used[j])
            if n:
                lognormal(0.0, float(ns.sigl[j]), size=n)

    def _commit_skips(self, ns, consumed: int) -> None:
        """Replay the real (side-effecting) `should_skip` for exactly the
        cancelled queue entries the committed prefix consumed, in scan
        order.  Safe because True answers are monotone: a peek that said
        True during compose still says True at the scalar's check time."""
        obs = self.observer
        invs = self.plan.invocations
        n = 0
        for p in ns.skip_offsets:
            if p >= consumed:
                break
            obs.should_skip(invs[self.cursor + p])
            n += 1
        self.skipped += n

    def _commit_state(self, ns, k: int, retried: bool = False) -> None:
        """Commit slots / pool / instance counters / queue for the first
        k dispatches and rewind the RNG(s) if the wave was truncated."""
        if k < ns.W:
            self._rewind_prefix(ns, k)
        push = ns.push
        if self.vm:
            self.slot_t[ns.slot_of[:k]] = push[:k]
        else:
            self.pool.apply(ns.warm, ns.pick, ns.drops, k)
            self.pool.push_batch(push[:k], ns.speedw[:k], ns.iidnum[:k])
            st = ns.slot_sorted
            if self.walk:
                self.slot_t = np.concatenate([st[k:], push[:k]])
            else:
                rel = np.sort(push[:k])
                rest = st[k:]
                self.slot_t = _merge_into(rest,
                                          np.searchsorted(rest, rel), rel)
            ncold = int(np.count_nonzero(ns.cold[:k]))
            self.cold_starts += ncold
            if self.multi:
                ck = ns.cold[:k]
                np.add.at(self.ninst_j, ns.jw[:k][ck], 1)
            else:
                self.ninst += ncold
                self.target._inst_counter = self.ninst
        nr_used = min(ns.nr, k)
        for _ in range(nr_used):
            self.retryq.popleft()
        qp = ns.lane_qpos
        if qp is None:
            self.cursor += k - nr_used
            return
        # skip-mode commit: figure out how far the scalar queue scan
        # advanced — through the last committed lane's entry (plus any
        # cancelled entries before it), or the whole scanned front when
        # every composed lane committed
        if retried:
            last = int(qp[k - 1])
            consumed = last + 1 if last >= 0 else 0
        elif k == ns.W:
            consumed = ns.scan_end
        else:
            nxt = int(qp[k])
            consumed = nxt if nxt >= 0 else 0
        self._commit_skips(ns, consumed)
        self.cursor += consumed

    def _obs_wave(self, ns, k: int, extra=None) -> None:
        """Wave-granularity emission over the committed prefix [0, k)."""
        if not k:
            return
        b, dur = ns.b[:k], ns.dur[:k]
        ncold = int(np.count_nonzero(ns.cold[:k]))
        if self._tr is not None:
            t0 = float(ns.pops[:k].min())
            t1 = float(ns.push[:k].max())
            args = {"n": int(k), "cold": ncold}
            if extra:
                args.update(extra)
            self._tr.span(f"wave{self._wave_idx}", cat="wave", ts=t0,
                          dur=max(0.0, t1 - t0), pid=self._lane,
                          tid="waves", args=args)
        self._wave_idx += 1
        if self._mx is not None:
            B = self._bm_inv.shape[0]
            self._bm_inv += np.bincount(b, minlength=B)
            self._bm_billed += np.bincount(b, weights=dur, minlength=B)
            self._mx.observe_many("engine.latency_s", dur,
                                  provider=self._provider)
        if self._mfeed is not None:
            # whole-wave windowed feed: arrays are in dispatch order, so
            # the rings accumulate exactly as the scalar per-event path
            self._mfeed.dispatch_wave(ns.pops[:k], dur, ns.cold[:k],
                                      ns.okv[:k], ns.timedv[:k])

    def _tally_fast(self, ns, k: int, retried: bool) -> None:
        if (self._tr is not None or self._mx is not None
                or self._mfeed is not None):
            self._obs_wave(ns, k, {"retried": bool(retried)})
        kacc = k
        if retried:
            self.retries_n += 1
            self.retryq.appendleft((int(ns.gidx[k - 1]),
                                    int(ns.att[k - 1]) + 1))
            kacc = k - 1
        self.wall = max(self.wall, float(ns.push[:k].max()))
        self.billed_chunks.append(ns.dur[:k].copy())
        if self.bmem is not None or self.multi:
            self.membid_chunks.append(ns.b[:k].copy())
        if not kacc:
            return
        o = ns.okv[:kacc]
        nok = int(np.count_nonzero(o))
        self.done_n += nok
        self.failed_n += kacc - nok
        self.timeouts += int(np.count_nonzero(ns.timedv[:kacc]))
        self.failures += int(np.count_nonzero(ns.platform[:kacc]))
        self.failures += int(np.count_nonzero(ns.benchfail[:kacc]))
        bk = ns.b[:kacc]
        cnt = None
        if nok == kacc:                   # every dispatch succeeded
            self.exec_mask[bk] = True
            Rw = ns.Rw[:kacc]
            if bool((Rw == Rw[0]).all()):
                R0 = int(Rw[0])
                v1w = ns.V1S[:kacc, :R0].ravel()
                v2w = ns.V2S[:kacc, :R0].ravel()
                cnt = np.full(kacc, R0, np.int64)
                self.pv1c.append(v1w)
                self.pv2c.append(v2w)
                self.pbidc.append(np.repeat(bk, R0))
                self.pcallc.append(np.repeat(ns.call[:kacc], R0))
                self.piidc.append(np.repeat(ns.iidnum[:kacc], R0))
                self.pcoldc.append(np.repeat(ns.cold[:kacc], R0))
        else:
            self.exec_mask[bk[o]] = True
            self.fail_mask[bk[(~o) & ~ns.platform[:kacc]]] = True
        if cnt is None:
            oi = np.flatnonzero(o)
            cnt = np.zeros(kacc, np.int64)
            if oi.shape[0]:
                reps = ns.Rw[oi]
                cnt[oi] = reps
                tot = int(reps.sum())
                rows = np.repeat(oi, reps)
                base = np.cumsum(reps) - reps
                cols = np.arange(tot) - np.repeat(base, reps)
                v1w = ns.V1S[rows, cols]
                v2w = ns.V2S[rows, cols]
                self.pv1c.append(v1w)
                self.pv2c.append(v2w)
                self.pbidc.append(np.repeat(bk[oi], reps))
                self.pcallc.append(np.repeat(ns.call[:kacc][oi], reps))
                self.piidc.append(np.repeat(ns.iidnum[:kacc][oi], reps))
                self.pcoldc.append(np.repeat(ns.cold[:kacc][oi], reps))
            else:
                v1w = v2w = np.zeros(0)
        if self.observer is not None:
            self._buffer_events(ns, kacc, cnt, v1w, v2w)

    # ---------------------------------------------------------- walk mode
    def _walk(self, ns, kv: int) -> None:
        """Hedging run: wave draws stay batched, but accounting replays
        the scalar main loop per dispatch because the hedge threshold is
        a running median over completion order and a fired hedge rewrites
        billing mid-wave."""
        cfg = self.cfg
        dur, push, platform = ns.dur, ns.push, ns.platform
        stop = kv
        fire = None
        for j in range(kv):
            dj = float(dur[j])
            self.billed_list.append(dj)
            if self.bmem is not None:
                self.mems_list.append(self.bmem[int(ns.b[j])])
            thr = self.hedge.threshold()
            if thr is not None and dj > thr:
                fire = ("hedge", j)
                stop = j + 1
                break
            self.wall = max(self.wall, float(push[j]))
            if platform[j] and int(ns.att[j]) < cfg.max_retries:
                fire = ("retry", j)
                stop = j + 1
                break
            self._account_one(ns, j)
        self._commit_state(ns, stop)
        if (self._tr is not None or self._mx is not None
                or self._mfeed is not None):
            self._obs_wave(ns, stop)
        if fire is not None:
            kind, j = fire
            if kind == "retry":
                self.retries_n += 1
                self.retryq.appendleft((int(ns.gidx[j]),
                                        int(ns.att[j]) + 1))
            else:
                self._hedge_fire(ns, j)
        self.wcap = min(cfg.parallelism, max(32, int(stop * 1.5) + 8))

    def _account_one(self, ns, j: int) -> None:
        bj = int(ns.b[j])
        if ns.timedv[j]:
            self.timeouts += 1
        if ns.okv[j]:
            self.done_n += 1
            self.exec_mask[bj] = True
            self.pairs_list.extend(self._pairs_of(ns, j))
            self.hedge.record(float(ns.dur[j]))
        else:
            self.failed_n += 1
            if ns.platform[j]:
                self.failures += 1
            else:
                self.fail_mask[bj] = True
                if ns.benchfail[j]:
                    self.failures += 1

    def _pairs_of(self, ns, j: int) -> List[DuetPair]:
        for u, out in ns.unst_outs:
            if u == j:
                return list(out.pairs)
        name = self.names[int(ns.b[j])]
        iid = ("vm%d" if self.vm else "i%d") % int(ns.iidnum[j])
        ci = int(ns.call[j])
        cs = bool(ns.cold[j])
        return [DuetPair(benchmark=name, v1_seconds=float(ns.V1S[j, r]),
                         v2_seconds=float(ns.V2S[j, r]), instance_id=iid,
                         call_index=ci, cold_start=cs)
                for r in range(int(ns.Rw[j]))]

    def _dispatch_one(self, inv: Invocation):
        """One scalar dispatch against live state (hedge twins); mirrors
        the scalar engine's heap-pop + acquire + release exactly."""
        target = self.target
        idx = int(np.argmin(self.slot_t))
        t = float(self.slot_t[idx])
        if self.vm:
            inst = Instance("vm%d" % idx, float(self.vm_speed[idx]))
            out = target.simulate(inv, inst, t, 0.0)
            t_end = t + out.duration_s
            self.slot_t[idx] = t_end
            return out, t, t_end, False
        row = self.pool.acquire_one(t, self.ka)
        if row >= 0:
            spd = float(self.pool._speed[row])
            iid = int(self.pool._iid[row])
            inst = Instance("i%d" % iid, spd)
            ov = 0.0
            cold = False
        else:
            target._inst_counter = self.ninst
            inst, ov = target.spawn_instance(inv, t, 0)
            self.ninst += 1
            self.cold_starts += 1
            spd = inst.speed
            iid = self.ninst
            cold = True
        out = target.simulate(inv, inst, t, ov)
        t_end = t + out.duration_s
        self.slot_t[idx] = t_end
        self.pool.push_one(t_end, spd, iid)
        return out, t, t_end, cold

    def _hedge_fire(self, ns, j: int) -> None:
        """Exact replica of the scalar hedge block for lane j, with the
        twin dispatched against the already-committed prefix state."""
        cfg = self.cfg
        self.hedged += 1
        inv = self.plan.invocations[int(ns.gidx[j])]
        t_start = float(ns.pops[j])
        t_end0 = float(ns.push[j])
        dur_j = float(ns.dur[j])
        ok0 = bool(ns.okv[j])
        alt_out, alt_ts, alt_te, alt_cold = self._dispatch_one(inv)
        if self._tr is not None:
            self._tr.instant("hedge", cat="engine", ts=alt_ts,
                             pid=self._lane, tid=f"b:{inv.benchmark}",
                             args={"original_dur_s": dur_j})
        if self._mx is not None:
            bj0 = int(ns.b[j])
            self._bm_inv[bj0] += 1
            self._bm_billed[bj0] += alt_out.duration_s
            self._mx.inc("engine.hedges", provider=self._provider)
            self._mx.observe("engine.latency_s", alt_out.duration_s,
                             provider=self._provider)
        if self._mfeed is not None:
            self._mfeed.dispatch(alt_ts, alt_out.duration_s, alt_cold,
                                 alt_out.ok, alt_out.timed_out)
        end_s = t_end0
        alt_billed = alt_out.duration_s
        alt_end = alt_te
        use_alt = alt_out.ok and ((not ok0) or alt_te < t_end0)
        if use_alt:
            if alt_te < t_end0:
                self.billed_list[-1] = max(0.0, min(dur_j,
                                                    alt_te - t_start))
                end_s = alt_te
        elif ok0:
            alt_billed = max(0.0, min(alt_billed, t_end0 - alt_ts))
            alt_end = min(alt_end, max(t_end0, alt_ts))
        self.billed_list.append(alt_billed)
        if self.bmem is not None:
            self.mems_list.append(self.bmem[int(ns.b[j])])
        self.wall = max(self.wall, alt_end)
        self.wall = max(self.wall, end_s)
        if use_alt:
            w_ok, w_timed = alt_out.ok, alt_out.timed_out
            w_plat = alt_out.platform_failure
            w_bf = alt_out.benchmark_failure
            w_dur = alt_out.duration_s
            w_pairs = list(alt_out.pairs)
        else:
            w_ok, w_timed = ok0, bool(ns.timedv[j])
            w_plat = bool(ns.platform[j])
            w_bf = bool(ns.benchfail[j])
            w_dur = dur_j
            w_pairs = self._pairs_of(ns, j) if ok0 else []
        if w_plat and int(ns.att[j]) < cfg.max_retries:
            self.retries_n += 1
            self.retryq.appendleft((int(ns.gidx[j]), int(ns.att[j]) + 1))
            return
        bj = int(ns.b[j])
        if w_timed:
            self.timeouts += 1
        if w_ok:
            self.done_n += 1
            self.exec_mask[bj] = True
            self.pairs_list.extend(w_pairs)
            self.hedge.record(w_dur)
        else:
            self.failed_n += 1
            if w_plat:
                self.failures += 1
            else:
                self.fail_mask[bj] = True
                if w_bf:
                    self.failures += 1

    # ------------------------------------------------------------- report
    def _report(self) -> EngineReport:
        if self.walk:
            billed_list: List[float] = self.billed_list
            pairs = self.pairs_list
            billed_arr = None
        else:
            billed_arr = (np.concatenate(self.billed_chunks)
                          if self.billed_chunks else np.zeros(0))
            billed_list = billed_arr.tolist()
            z = np.zeros(0)
            zi = np.zeros(0, np.int64)
            zb = np.zeros(0, bool)
            pairs = PairSeq(
                self.names, "vm" if self.vm else "i",
                np.concatenate(self.pbidc) if self.pbidc else zi,
                np.concatenate(self.pcallc) if self.pcallc else zi,
                np.concatenate(self.piidc) if self.piidc else zi,
                np.concatenate(self.pcoldc) if self.pcoldc else zb,
                np.concatenate(self.pv1c) if self.pv1c else z,
                np.concatenate(self.pv2c) if self.pv2c else z)
        wall = self.wall
        if self.vm:
            cost = self.outer.finalize(billed_list, wall)
        elif self.multi:
            # the router's finalize groups billing per job (sorted jid
            # order) and prices through each job's backend — rebuild its
            # job tags and per-invocation memory logs aligned with our
            # billing order, then delegate for bit-identical cost math
            memb = (np.concatenate(self.membid_chunks)
                    if self.membid_chunks else np.zeros(0, np.int64))
            jarr = self.combo_jidx[memb]
            jl = jarr.tolist()
            self.target._sim_jobs = [self.jobs[x] for x in jl]
            if self.any_memmap:
                bm = self.bmem_list
                ml = memb.tolist()
                for jx, be in enumerate(self.bes):
                    if be.memory_map is not None:
                        be._sim_mem = [bm[mi] for mi, jj in zip(ml, jl)
                                       if jj == jx]
            for jx, be in enumerate(self.bes):
                be._inst_counter = int(self.ninst_j[jx])
            cost = self.outer.finalize(billed_list, wall)
        elif self.bmem is not None:
            # finalize()'s per-invocation pricing zips billed with the
            # backend's memory log; rebuild it aligned with our billing
            # order (direct simulate calls polluted it with junk entries)
            if self.walk:
                self.target._sim_mem = list(self.mems_list)
            else:
                memb = (np.concatenate(self.membid_chunks)
                        if self.membid_chunks else np.zeros(0, np.int64))
                bm = self.bmem
                self.target._sim_mem = [bm[i] for i in memb.tolist()]
            cost = self.outer.finalize(billed_list, wall)
        else:
            arr = (billed_arr if billed_arr is not None
                   else np.asarray(billed_list))
            cost = self.target.finalize_batch(arr, wall)
        if self._mx is not None:
            mx, prov = self._mx, self._provider
            for i, name in enumerate(self.names):
                n = int(self._bm_inv[i])
                if n:
                    mx.inc("engine.invocations", n, provider=prov,
                           benchmark=name)
                    mx.inc("engine.billed_s", float(self._bm_billed[i]),
                           provider=prov, benchmark=name)
            n_disp = int(self._bm_inv.sum())
            if self.cold_starts:
                mx.inc("engine.cold_starts", self.cold_starts,
                       provider=prov)
            if n_disp - self.cold_starts > 0:
                mx.inc("engine.warm_hits", n_disp - self.cold_starts,
                       provider=prov)
            if self.retries_n:
                mx.inc("engine.retries", self.retries_n, provider=prov)
            mx.inc("engine.cost_usd", cost, provider=prov)
            span = self.cfg.parallelism * max(wall - self.start_s, 0.0)
            if span > 0:
                mx.set_gauge("engine.slot_utilization",
                             min(1.0, float(sum(billed_list)) / span),
                             provider=prov)
            if n_disp:
                mx.set_gauge("engine.warm_hit_rate",
                             1.0 - self.cold_starts / n_disp,
                             provider=prov)
                mx.set_gauge("engine.cold_start_rate",
                             self.cold_starts / n_disp, provider=prov)
        if self._mon is not None:
            # drain detectors/SLO evaluators up to this run's horizon
            self._mon.evaluate(wall)
        ex = {self.names[i]
              for i in np.flatnonzero(self.exec_mask).tolist()}
        fl = {self.names[i]
              for i in np.flatnonzero(self.fail_mask).tolist()}
        return EngineReport(
            pairs=pairs, wall_seconds=wall,
            billed_seconds=billed_list, cost_dollars=cost,
            cold_starts=self.cold_starts, timeouts=self.timeouts,
            failures=self.failures,
            executed_benchmarks=sorted(ex - fl),
            failed_benchmarks=sorted(fl),
            invocations_done=self.done_n,
            invocations_failed=self.failed_n,
            retries=self.retries_n, hedged=self.hedged,
            skipped=self.skipped)


class VectorEngine:
    """Drop-in `ExecutionEngine` with the vectorized virtual-time core.

    Same constructor and `run` contract; runs the fast path when the
    backend qualifies (see `_vector_target`) and transparently delegates
    to the scalar engine otherwise — observer-driven runs, shared warm
    pools, realtime backends, active chaos."""

    def __init__(self, backend, cfg: Optional[EngineConfig] = None):
        self.backend = backend
        self.cfg = cfg or EngineConfig()
        self._scalar = ExecutionEngine(backend, self.cfg)

    def run(self, plan: SuitePlan, observer=None, *,
            warm_pool=None, start_s: float = 0.0) -> EngineReport:
        from repro_torch.faas.backends import VMBackend
        target, _outer = _vector_target(self.backend)
        walk = self.cfg.hedge_after_factor > 0
        vm = isinstance(target, VMBackend)
        reason = None
        if target is None:
            reason = "backend is not vectorizable (active chaos " \
                     "or a custom backend)"
        elif getattr(self.backend, "realtime", False):
            reason = "realtime backend"
        elif walk and getattr(target, "is_router", False):
            reason = "hedging on a routed fleet"
        elif observer is not None:
            if not getattr(observer, "wave_eligible", False):
                reason = "observer is not wave-eligible"
            elif walk:
                reason = "hedging with an observer"
            elif vm and observer.skip_possible():
                reason = "skip-capable observer on a pinned fleet"
        if reason is None and warm_pool is not None:
            if vm:
                reason = "warm pool on a pinned fleet"
            elif not _pool_importable(warm_pool):
                reason = "warm pool holds foreign instances"
        if reason is not None:
            _note_fallback(reason)
            return self._scalar.run(plan, observer, warm_pool=warm_pool,
                                    start_s=start_s)
        return _VecRun(self.cfg, target, self.backend, plan, start_s,
                       observer=observer,
                       warm_pool=warm_pool).execute()


_DEFAULT_ENGINE = "fast"


def set_default_engine(engine: str) -> None:
    """Process-wide default used by ``make_engine(engine=None)`` callers —
    the funnel for ``--engine fast|reference`` CLI flags."""
    if engine not in ("fast", "reference"):
        raise ValueError(f"unknown engine {engine!r} "
                         "(expected 'fast' or 'reference')")
    global _DEFAULT_ENGINE
    _DEFAULT_ENGINE = engine


def make_engine(backend, cfg: Optional[EngineConfig] = None, *,
                engine: Optional[str] = None):
    """Engine factory: ``fast`` (vectorized, the default) or ``reference``
    (the scalar event loop).  Both produce identical reports; ``None``
    picks up the process default (`set_default_engine`)."""
    if engine is None:
        engine = _DEFAULT_ENGINE
    if engine == "reference":
        return ExecutionEngine(backend, cfg)
    if engine != "fast":
        raise ValueError(f"unknown engine {engine!r} "
                         "(expected 'fast' or 'reference')")
    return VectorEngine(backend, cfg)
