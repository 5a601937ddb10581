"""The service scheduler: many concurrent jobs on shared engine fleets.

One `BenchmarkService` owns a set of per-provider *fleets*.  Each fleet
is one `ExecutionEngine` (PR-1) plus a persistent `WarmPool` and a
`FairQueue`: submitted jobs are expanded into job-tagged RMIT
invocations, interleaved across tenants in weighted-fair order, and
executed as one virtual-time schedule — concurrent jobs genuinely share
the fleet's slots and each other's warm instances, exactly like CI
pipelines sharing a real deployment.

A `_JobRouterBackend` multiplexes the platform model per job: every job
keeps its own RNG stream (seeded by the job seed), memory configuration
(uniform or autotuned map), and billing.  Cold starts and warm reuse
reflect the *combined* load — like a real shared fleet, co-tenancy
changes which invocations pay cold starts and which instances (drawn
from whichever job spawned them) a job's work lands on, so a job's raw
timings are not identical to a solo run of the same job.  What IS
guaranteed is batch-level determinism: the same set of submissions with
the same seeds replays the identical schedule, timings, and bills.

Service-level policies on top of the engine:

  * admission control (jobs.py) — a rejected job schedules nothing;
  * over-budget preemption — a job whose metered bill exceeds its budget
    is cancelled mid-run (its remaining invocations are skipped, its
    partial results still delivered, marked `preempted`);
  * causally ordered delivery — each tenant receives its JobResults in
    submission order, at virtual times that never precede the results
    they contain (a tenant's commit N+1 can never land before commit N);
  * online re-planning (replan.py, opt-in via `attach_controller`) —
    admission-time migration off degraded providers, retry hedging under
    timeout storms, elastic deferral while incidents are open, deadline
    renegotiation, and resumption of preempted jobs at round boundaries.

Determinism: same submissions + same seeds => identical dispatch order,
schedules, bills, and delivery order (`ServiceReport.digest()` is golden-
tested at 16+ concurrent jobs).
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import rmit
from repro_torch.core.results import analyze
from repro_torch.core.rmit import SuitePlan
from repro_torch.faas.backends import (PROVIDER_PROFILES, ProviderProfile,
                                 SimFaaSBackend)
from repro_torch.faas.engine import (CompletedInvocation, EngineConfig,
                               EngineObserver, EngineReport, ExecutionEngine,
                               WarmPool)
from repro_torch.service.jobs import (AdmissionConfig, AdmissionError, Job,
                                JobResult, JOB_COMPLETED, JOB_PREEMPTED,
                                check_admission)
from repro_torch.service.planner import (CandidatePlan, DeadlineCostPlanner,
                                   VM_PROVIDER)
from repro_torch.service.queue import FairQueue


@dataclass
class ServiceConfig:
    parallelism: int = 150              # slots per fleet (paper §6.1)
    memory_mb: int = 2048               # default uniform function memory
    preempt_over_budget: bool = True
    max_retries: int = 0
    tenant_weights: Dict[str, float] = field(default_factory=dict)
    admission: AdmissionConfig = field(default_factory=AdmissionConfig)
    seed: int = 0
    engine: object = None               # scheduler core: "fast"/"reference"
    #                                     (None = process default).  Fleet
    #                                     runs share a persistent WarmPool,
    #                                     which the vectorized core hands
    #                                     to its embedded scalar loop — the
    #                                     knob exists so operators can pin
    #                                     "reference" explicitly.
    analysis_n_boot: object = None      # bootstrap resamples for per-job
    #                                     change analysis (None = stats
    #                                     default).  Scale-out deployments
    #                                     lower it: analysis runs once per
    #                                     job, so its cost is pure overhead
    #                                     on the dispatch path.
    schedule_quantum: int = 1           # invocations dealt to the fleet per
    #                                     fair-queue item (deficit-round-
    #                                     robin batching).  1 = per-
    #                                     invocation WFQ interleave (exact
    #                                     historical dispatch order); larger
    #                                     quanta keep each job's lanes in
    #                                     contiguous blocks so the
    #                                     vectorized core fills whole waves
    #                                     from one RNG stream — fairness
    #                                     holds over windows of ~quantum
    #                                     estimated seconds instead of per
    #                                     invocation.
    chaos: object = None                # faas/chaos.py ChaosConfig: wraps
    #                                     every fleet's router in the
    #                                     fault-injection layer (None =
    #                                     calm; zero intensity is a
    #                                     tested identity).  A dict maps
    #                                     provider name -> ChaosConfig so
    #                                     an incident can be scoped to
    #                                     one provider while the others
    #                                     stay calm (the re-planner's
    #                                     migration-target scenario).
    slo: object = None                  # live SLO monitoring (obs/slo.py):
    #                                     True = stock objectives, a path =
    #                                     load_slos(path), or a list of
    #                                     SLOSpec.  Arms an SLOMonitor on
    #                                     the obs context (creating a
    #                                     monitoring context if none is
    #                                     installed); None = no monitoring.


@dataclass
class SubmitReceipt:
    """What `submit` hands back: where the job will run."""
    job_id: str
    provider: str
    memory_mb: int
    parallelism: int
    n_invocations: int
    plan: Optional[CandidatePlan] = None    # set when the planner chose


class _JobExec:
    """Internal per-job execution state."""

    def __init__(self, job: Job, backend: SimFaaSBackend, provider: str,
                 memory_mb: int, submit_seq: int, enqueue_clock_s: float,
                 n_invocations: int, plan: Optional[CandidatePlan]):
        self.job = job
        self.backend = backend
        self.provider = provider
        self.memory_mb = memory_mb
        self.submit_seq = submit_seq
        self.enqueue_clock_s = enqueue_clock_s
        self.pending = n_invocations
        self.n_planned = n_invocations
        self.plan = plan
        self.cancelled = False
        self.preempted = False
        self.n_done = 0
        self.n_skipped = 0
        self.pairs: List = []
        self.pchunks: List = []         # wave-path pair columns, turned
        #                                 into `pairs` by flush_pairs()
        self.bchunks: List = []         # wave-path (combo, durs) chunks,
        #                                 folded into bench_inv/bench_billed
        #                                 by flush_pairs()
        self.executed: set = set()
        self.failed: set = set()
        self.infra_failed: set = set()
        self.bench_inv: Dict[str, int] = {}
        self.bench_billed: Dict[str, float] = {}
        self.billed_s = 0.0
        self.cost_est = 0.0             # metered incrementally (preemption)
        self.cost_final = 0.0           # from the backend's billing model
        self.start_s = float("inf")
        self.end_s = 0.0
        self.result: Optional[JobResult] = None


class _JobRouterBackend:
    """Backend multiplexer: routes every engine callback to the backend
    of the invocation's job (rmit.Invocation.job_id).  All jobs in one
    fleet share the provider profile — and through the engine, the slots
    and the warm pool — but keep private RNG streams, memory configs,
    and bills."""

    realtime = False
    pinned = False
    is_router = True        # vectorized engine: SoA job-tag routing
    #                         (engine_vec qualifies the fleet when every
    #                         routed backend is a plain simulated one on
    #                         the fleet profile)

    def __init__(self, profile: ProviderProfile):
        self.profile = profile
        self.backends: Dict[str, SimFaaSBackend] = {}
        self._sim_jobs: List[str] = []      # job id per simulate() call,
        #                                     aligned with the billed list
        self.billed_by_job: Dict[str, List[float]] = {}
        self.cost_by_job: Dict[str, float] = {}

    @property
    def keep_alive_s(self) -> float:
        return self.profile.keep_alive_s

    def add_job(self, job_id: str, backend: SimFaaSBackend) -> None:
        self.backends[job_id] = backend

    def begin_run(self, parallelism: int) -> None:
        self._sim_jobs = []
        for jid in sorted(self.backends):
            self.backends[jid].begin_run(parallelism)

    def spawn_instance(self, inv, t, slot):
        return self.backends[inv.job_id].spawn_instance(inv, t, slot)

    def simulate(self, inv, instance, t, overhead_s):
        self._sim_jobs.append(inv.job_id)
        return self.backends[inv.job_id].simulate(inv, instance, t,
                                                  overhead_s)

    def finalize(self, billed_seconds: List[float],
                 wall_seconds: float) -> float:
        """Per-job billing: the engine bills in simulate order, so the
        recorded job ids partition the billed list exactly (including
        hedge-cancellation caps applied by the engine)."""
        grouped: Dict[str, List[float]] = {}
        for b, jid in zip(billed_seconds, self._sim_jobs):
            grouped.setdefault(jid, []).append(b)
        total = 0.0
        for jid, billed in sorted(grouped.items()):
            cost = self.backends[jid].finalize(billed, wall_seconds)
            self.billed_by_job[jid] = billed
            self.cost_by_job[jid] = cost
            total += cost
        return total


class _FleetObserver(EngineObserver):
    """Routes engine results to jobs; meters per-job billing; preempts
    jobs that exceed their budget (their remaining invocations are
    skipped before dispatch, so they are neither executed nor billed)."""

    def __init__(self, jobs: Dict[str, _JobExec], profile: ProviderProfile,
                 preempt: bool, controller=None):
        self.jobs = jobs
        self.profile = profile
        self.preempt = preempt
        # re-plan hook: the controller gets a read-only pulse at every
        # delivery boundary (scalar: per event; vectorized: per wave).
        # Pulses only advance the monitor and the controller's trigger
        # state — actions are committed at admission / round boundaries,
        # so an armed controller with no open trigger perturbs nothing.
        self._ctrl = controller
        # exact budget shadow (skip_exact): per budget-job pending
        # completions the engine has buffered but not yet delivered,
        # each as (t_end, buffer_seq, cost) kept in delivery order
        self._shadow: Dict[str, List[tuple]] = {}
        self._shseq = 0
        self._flip: Dict[str, float] = {}   # memoized skip_flip_s
        # resolved once per batch (one observer per fleet run); emission
        # below only reads values already computed by the engine/backend
        from repro_torch.obs import get_obs
        obs = get_obs()
        on = obs is not None and obs.enabled
        self._tr = obs.tracer if on else None
        self._mx = obs.metrics if on else None
        self._rec = obs.recorder if on else None
        self._mon = obs.monitor if obs is not None else None

    def should_skip(self, inv) -> bool:
        ex = self.jobs[inv.job_id]
        if ex.cancelled:
            ex.n_skipped += 1
            ex.pending -= 1
            return True
        return False

    def on_result(self, done: CompletedInvocation) -> None:
        ex = self.jobs[done.invocation.job_id]
        out = done.outcome
        b = done.invocation.benchmark
        ex.pending -= 1
        ex.n_done += 1
        ex.start_s = min(ex.start_s, done.t_start)
        ex.end_s = max(ex.end_s, done.t_end)
        ex.bench_inv[b] = ex.bench_inv.get(b, 0) + 1
        ex.bench_billed[b] = ex.bench_billed.get(b, 0.0) + out.duration_s
        ex.billed_s += out.duration_s
        ex.cost_est += self.profile.billed_cost(
            [out.duration_s], ex.backend.memory_for(b))
        if out.ok:
            ex.executed.add(b)
            ex.pairs.extend(out.pairs)
        elif out.platform_failure:
            ex.infra_failed.add(b)      # transient: condemned only if the
            #                             benchmark never succeeds at all
        else:
            ex.failed.add(b)
        if self._mx is not None:
            self._mx.inc("service.invocations", tenant=ex.job.tenant,
                         provider=self.profile.name, benchmark=b)
            self._mx.inc("service.billed_s", out.duration_s,
                         tenant=ex.job.tenant, provider=self.profile.name)
        budget = ex.job.budget_usd
        if self._mon is not None and budget:
            # SLO progress: cost burn fraction at this delivery instant
            self._mon.job_event("budget", done.t_end, job=ex.job.job_id,
                                tenant=ex.job.tenant,
                                frac=ex.cost_est / budget)
        if (self.preempt and budget is not None and not ex.cancelled
                and ex.cost_est > budget):
            ex.cancelled = True
            ex.preempted = True
            ctx = {"job": ex.job.job_id, "tenant": ex.job.tenant,
                   "cost_est_usd": ex.cost_est, "budget_usd": budget}
            if self._tr is not None:
                self._tr.instant("preempt", cat="service", ts=done.t_end,
                                 pid="tenants", tid=ex.job.tenant,
                                 args=ctx)
            if self._mx is not None:
                self._mx.inc("service.preemptions", tenant=ex.job.tenant,
                             provider=self.profile.name)
            if self._rec is not None:
                self._rec.dump("preemption", ts=done.t_end, context=ctx)
            if self._mon is not None:
                self._mon.job_event("preempted", done.t_end,
                                    job=ex.job.job_id,
                                    tenant=ex.job.tenant)
        if (self._mon is not None and ex.pending == 0
                and not ex.preempted):
            # the job's last invocation just delivered: its SLO clock
            # stops at end_s (the causal delivery instant in run() can
            # only be later, and deadlines are judged on end_s)
            self._mon.job_event("delivered", ex.end_s, job=ex.job.job_id,
                                tenant=ex.job.tenant)
        if self._ctrl is not None:
            self._ctrl.pulse(self.profile.name, done.t_end)

    # ----------------------------------------------- batched delivery
    # The vectorized engine hands completions over as validity-truncated
    # waves (`CompletedWave`), already in the scalar completion heap's
    # drain order.  Everything below replays on_result's effects with
    # array ops, bit-for-bit: float accumulators use the
    # cumsum-from-prior trick (sequential-add exact), per-event costs
    # replicate `ProviderProfile.billed_cost` term by term, and budget
    # preemption fires at the first crossing event in delivered order.
    wave_eligible = True

    def peek_skip(self, inv) -> bool:
        # pure preview: the real `should_skip` (which counts the skip) is
        # replayed by the engine at commit time
        return self.jobs[inv.job_id].cancelled

    def skip_possible(self) -> bool:
        return self.preempt and any(
            ex.job.budget_usd is not None or ex.cancelled
            for ex in self.jobs.values())

    def skip_volatile(self, inv) -> bool:
        # cancellation only ever flips through budget preemption, and
        # only once (monotone): a lane of a budget-less job answers a
        # constant False, a cancelled job's lane a monotone True — both
        # safe to preview past the frozen-observer horizon
        ex = self.jobs[inv.job_id]
        return ex.job.budget_usd is not None and not ex.cancelled

    def _build_ctab(self, cb, cj, iid_prefix) -> None:
        """Per-combo lookup tables ((job, benchmark) pairs are fixed for
        the whole engine run, so this happens once per fleet batch)."""
        import numpy as np
        jids = list(dict.fromkeys(cj))
        jof = {j: i for i, j in enumerate(jids)}
        self._jlist = [self.jobs[j] for j in jids]
        self._jids = jids
        C = len(cb)
        # memory/cpu-share from the same Python-number calls the scalar
        # path makes, so the per-event cost factors match bitwise
        mems = [self.jobs[cj[c]].backend.memory_for(cb[c])
                for c in range(C)]
        tens = list(dict.fromkeys(ex.job.tenant for ex in self._jlist))
        tof = {t: i for i, t in enumerate(tens)}
        self._ctab = (
            np.fromiter((jof[j] for j in cj), np.int64, C),
            np.array([float(m) for m in mems]),
            np.array([self.profile.cpu_share(m) for m in mems]),
            np.fromiter((tof[self.jobs[j].job.tenant] for j in cj),
                        np.int64, C),
            tens,
        )
        self._budgeted = np.array(
            [ex.job.budget_usd is not None for ex in self._jlist], bool)
        self._prefix = iid_prefix
        self._names = list(cb)

    def _cost_ev(self, combo, durs):
        """Per-event cost == billed_cost([d], mem): same ops, same
        order (shared by delivery accounting and the budget shadow, so
        shadowed and delivered costs match bitwise)."""
        import numpy as np
        _, mem_c, share_c, _, _ = self._ctab
        p = self.profile
        g, m = p.billing_granularity_s, p.min_billed_s
        rb = durs
        if g or m:
            rb = np.maximum(durs, m)
            if g:
                rb = np.ceil(rb / g) * g
        cost_ev = (rb * mem_c[combo] / 1024.0 * p.per_gb_second
                   + p.per_request)
        if p.per_ghz_second:
            cost_ev = cost_ev + (rb * p.cpu_base_ghz * share_c[combo]
                                 * p.per_ghz_second)
        return cost_ev

    # ------------------------------------------- exact budget shadow
    # The vectorized engine buffers completions until the virtual clock
    # reaches them; until delivery, a budget job's cancellation flip is
    # invisible to `peek_skip`.  The shadow mirrors those buffered
    # events' costs so `skip_flip_s` can answer the *exact* delivery
    # instant of the budget crossing: costs are computed with the same
    # elementwise ops as delivery accounting, and the running sum walks
    # pending events in (t_end, buffer order) — exactly the engine's
    # global flush order restricted to this job — so the crossing index
    # matches `_job_wave`'s cumsum crossing bit for bit.
    skip_exact = True

    def skip_shadow(self, combo, t_end, duration_s, combo_bench,
                    combo_job) -> None:
        if not self.preempt:
            return
        import numpy as np
        from bisect import insort
        if getattr(self, "_ctab", None) is None:
            self._build_ctab(combo_bench, combo_job, "i")
        cjid = self._ctab[0]
        jev = cjid[combo]
        tr = self._budgeted[jev]
        seq0 = self._shseq
        self._shseq = seq0 + int(combo.shape[0])
        if not tr.any():
            return
        cost = self._cost_ev(combo, duration_s)
        for n in np.flatnonzero(tr).tolist():
            jid = self._jids[int(jev[n])]
            pend = self._shadow.get(jid)
            if pend is None:
                pend = self._shadow[jid] = []
            # chunks arrive in buffer order but t_end within a chunk is
            # unsorted; keep per-job pending in delivery order
            insort(pend, (float(t_end[n]), seq0 + n, float(cost[n])))
            self._flip.pop(jid, None)

    def skip_flip_s(self, inv) -> float:
        jid = inv.job_id
        hit = self._flip.get(jid)
        if hit is not None:
            return hit
        ex = self.jobs[jid]
        budget = ex.job.budget_usd
        ts = math.inf
        pend = self._shadow.get(jid)
        if pend and budget is not None and not ex.cancelled:
            # sequential float adds == np.cumsum: the partial sums match
            # the delivery-time crossing check bitwise
            c = ex.cost_est
            for te, _seq, cost in pend:
                c = c + cost
                if c > budget:
                    ts = te
                    break
        self._flip[jid] = ts
        return ts

    def on_wave(self, wave) -> None:
        if wave.combo_job is None:      # not a routed fleet: per-event
            EngineObserver.on_wave(self, wave)
            return
        import numpy as np
        if len(wave) == 0:
            return
        if getattr(self, "_ctab", None) is None:
            self._build_ctab(wave.combo_bench, wave.combo_job,
                             wave.iid_prefix)
        cjid, mem_c, share_c, ctc, tens = self._ctab
        combo = wave.combo
        durs = wave.duration_s
        p = self.profile
        cost_ev = self._cost_ev(combo, durs)
        jev = cjid[combo]
        order = np.argsort(jev, kind="stable")
        cuts = np.flatnonzero(np.diff(jev[order])) + 1
        for idx in np.split(order, cuts):
            self._job_wave(self._jlist[int(jev[idx[0]])], wave, idx,
                           durs, cost_ev)
        if self._mx is not None:
            # counter-key first-touch order matches the scalar per-event
            # path: combos (-> tenant x benchmark keys) in first-event
            # order, then each tenant's billed seconds in event order
            cu, first = np.unique(combo, return_index=True)
            for c in cu[np.argsort(first)].tolist():
                ex = self._jlist[int(cjid[c])]
                self._mx.inc("service.invocations",
                             float(int((combo == c).sum())),
                             tenant=ex.job.tenant, provider=p.name,
                             benchmark=wave.combo_bench[c])
            tev = ctc[combo]
            tu, tfirst = np.unique(tev, return_index=True)
            for t in tu[np.argsort(tfirst)].tolist():
                self._mx.inc_seq("service.billed_s", durs[tev == t],
                                 tenant=tens[t], provider=p.name)
        if self._ctrl is not None:
            self._ctrl.pulse(p.name, float(wave.t_end.max()))

    def _job_wave(self, ex: "_JobExec", wave, idx, durs, cost_ev) -> None:
        import numpy as np
        k = int(idx.shape[0])
        pend = self._shadow.get(ex.job.job_id)
        if pend:
            # delivery follows global (t_end, buffer order): the wave's
            # events for this job are exactly the pending prefix
            del pend[:k]
            self._flip.pop(ex.job.job_id, None)
        ex.pending -= k
        ex.n_done += k
        te = wave.t_end[idx]
        ex.start_s = min(ex.start_s, float(wave.t_start[idx].min()))
        ex.end_s = max(ex.end_s, float(te.max()))
        d = durs[idx]
        combo = wave.combo[idx]
        # per-benchmark billing/counts are only read at job finalization,
        # so they accumulate as raw chunks and fold once in flush_pairs()
        ex.bchunks.append((combo, d))
        arr = np.empty(k + 1)
        arr[0] = ex.billed_s
        arr[1:] = d
        ex.billed_s = float(np.cumsum(arr)[-1])
        carr = np.empty(k + 1)
        carr[0] = ex.cost_est
        carr[1:] = cost_ev[idx]
        cum = np.cumsum(carr)
        ok = wave.ok[idx]
        pf = wave.platform_failure[idx]
        for c in np.unique(combo[ok]).tolist():
            ex.executed.add(wave.combo_bench[c])
        for c in np.unique(combo[pf]).tolist():
            ex.infra_failed.add(wave.combo_bench[c])
        for c in np.unique(combo[~ok & ~pf]).tolist():
            ex.failed.add(wave.combo_bench[c])
        cnt = wave.pair_cnt[idx]
        tot = int(cnt.sum())
        if tot:
            off = wave.pair_off[idx]
            base = np.cumsum(cnt) - cnt
            pos = np.repeat(off - base, cnt) + np.arange(tot)
            ex.pchunks.append((np.repeat(combo, cnt),
                               np.repeat(wave.call[idx], cnt),
                               np.repeat(wave.iid_num[idx], cnt),
                               np.repeat(wave.cold[idx], cnt),
                               wave.pair_v1[pos], wave.pair_v2[pos]))
        budget = ex.job.budget_usd
        if self.preempt and budget is not None and not ex.cancelled:
            over = np.flatnonzero(cum[1:] > budget)
            if over.shape[0]:
                i0 = int(over[0])
                ex.cancelled = True
                ex.preempted = True
                ts = float(te[i0])
                ctx = {"job": ex.job.job_id, "tenant": ex.job.tenant,
                       "cost_est_usd": float(cum[1 + i0]),
                       "budget_usd": budget}
                if self._tr is not None:
                    self._tr.instant("preempt", cat="service", ts=ts,
                                     pid="tenants", tid=ex.job.tenant,
                                     args=ctx)
                if self._mx is not None:
                    self._mx.inc("service.preemptions",
                                 tenant=ex.job.tenant,
                                 provider=self.profile.name)
                if self._rec is not None:
                    self._rec.dump("preemption", ts=ts, context=ctx)
                if self._mon is not None:
                    self._mon.job_event("preempted", ts,
                                        job=ex.job.job_id,
                                        tenant=ex.job.tenant)
        ex.cost_est = float(cum[-1])
        if self._mon is not None:
            # SLO progress at wave granularity: one burn sample per
            # flushed wave, plus the completion event when it empties
            if budget:
                self._mon.job_event("budget", float(te[-1]),
                                    job=ex.job.job_id,
                                    tenant=ex.job.tenant,
                                    frac=ex.cost_est / budget)
            if ex.pending == 0 and not ex.preempted:
                self._mon.job_event("delivered", ex.end_s,
                                    job=ex.job.job_id,
                                    tenant=ex.job.tenant)

    def flush_pairs(self) -> None:
        """Turn wave-accumulated pair columns into each job's `pairs`
        as a lazy array-backed sequence (order matches the per-event
        path: delivery order, repeat order within an invocation).
        No-op after a scalar run."""
        if getattr(self, "_ctab", None) is None:
            return
        import numpy as np
        from repro_torch.faas.engine_vec import PairSeq
        for ex in self.jobs.values():
            if ex.bchunks:
                combo = np.concatenate([c for c, _ in ex.bchunks])
                d = np.concatenate([dm for _, dm in ex.bchunks])
                cu, first = np.unique(combo, return_index=True)
                for c in cu[np.argsort(first)].tolist():
                    b = self._names[c]
                    dm = d[combo == c]
                    ex.bench_inv[b] = (ex.bench_inv.get(b, 0)
                                       + int(dm.shape[0]))
                    arr = np.empty(dm.shape[0] + 1)
                    arr[0] = ex.bench_billed.get(b, 0.0)
                    arr[1:] = dm
                    ex.bench_billed[b] = float(np.cumsum(arr)[-1])
                ex.bchunks = []
            ch = ex.pchunks
            if not ch:
                continue
            cols = [np.concatenate([c[i] for c in ch]) for i in range(6)]
            ex.pairs = PairSeq(self._names, self._prefix, cols[0],
                               cols[1], cols[2], cols[3], cols[4],
                               cols[5])
            ex.pchunks = []


class _Fleet:
    """One provider fleet: engine + persistent warm pool + fair queue."""

    def __init__(self, provider: str, parallelism: int, cfg: ServiceConfig,
                 *, max_retries: Optional[int] = None):
        if provider == VM_PROVIDER:
            raise ValueError("the service schedules elastic FaaS fleets; "
                             "the VM baseline runs standalone")
        self.provider = provider
        self.parallelism = parallelism
        self.cfg = cfg
        self.profile = PROVIDER_PROFILES[provider]
        self.router = _JobRouterBackend(self.profile)
        backend = self.router
        chaos = cfg.chaos
        if isinstance(chaos, dict):
            chaos = chaos.get(provider)     # provider-scoped scenarios
        self.chaos_backend = None
        if chaos is not None:
            # chaos wraps the whole fleet: faults hit jobs of every
            # tenant through one shared (seeded) scenario, exactly like
            # a real provider incident; the per-invocation fault RNG is
            # keyed by job id so tenants stay mutually deterministic
            from repro_torch.faas.chaos import ChaosBackend
            backend = self.chaos_backend = ChaosBackend(self.router, chaos)
        from repro_torch.faas.engine_vec import make_engine
        self.max_retries = (cfg.max_retries if max_retries is None
                            else max_retries)
        self.engine = make_engine(
            backend, EngineConfig(parallelism=parallelism,
                                  max_retries=self.max_retries),
            engine=cfg.engine)
        self.warm_pool = WarmPool()
        self.queue = FairQueue(weights=dict(cfg.tenant_weights))
        self.jobs: Dict[str, _JobExec] = {}
        self.clock_s = 0.0              # carried across run batches so the
        #                                 shared warm pool's time stays
        #                                 non-decreasing
        self.cold_starts = 0
        self.reports: List[EngineReport] = []

    def enqueue(self, ex: _JobExec, plan: SuitePlan) -> None:
        self.router.add_job(ex.job.job_id, ex.backend)
        self.jobs[ex.job.job_id] = ex
        repeats = ex.job.repeats_per_call
        quantum = max(1, int(self.cfg.schedule_quantum))
        group: list = []
        group_est = 0.0
        for inv in rmit.tag_plan(plan, ex.job.job_id).invocations:
            wl = ex.job.workloads[inv.benchmark]
            est_s = 2.0 * repeats * getattr(wl, "base_seconds", 1.0)
            group.append(inv)
            group_est += est_s
            if len(group) >= quantum:
                self.queue.push(ex.job.tenant, group, size=group_est,
                                weight_scale=ex.job.priority)
                group, group_est = [], 0.0
        if group:
            self.queue.push(ex.job.tenant, group, size=group_est,
                            weight_scale=ex.job.priority)

    def run(self, cfg: ServiceConfig,
            controller=None) -> List[_JobExec]:
        """Execute everything queued; returns the jobs of this batch."""
        order = [inv for _, grp in self.queue.drain() for inv in grp]
        batch = [ex for ex in self.jobs.values() if ex.result is None]
        if not order:
            return batch
        plan = SuitePlan(invocations=tuple(order), n_calls=0,
                         repeats_per_call=0)
        observer = _FleetObserver(self.jobs, self.profile,
                                  cfg.preempt_over_budget,
                                  controller=controller)
        rep = self.engine.run(plan, observer=observer,
                              warm_pool=self.warm_pool,
                              start_s=self.clock_s)
        observer.flush_pairs()
        self.clock_s = max(self.clock_s, rep.wall_seconds)
        self.cold_starts += rep.cold_starts
        self.reports.append(rep)
        for ex in batch:
            ex.cost_final = self.router.cost_by_job.get(ex.job.job_id, 0.0)
            billed = self.router.billed_by_job.get(ex.job.job_id, [])
            # exact bill (includes retried attempts the observer never saw)
            ex.billed_s = float(sum(billed))
        return batch


def jain_fairness(values: Sequence[float]) -> float:
    """Jain's fairness index over per-tenant service: 1.0 = perfectly
    even, 1/n = one tenant got everything."""
    vals = [v for v in values]
    if not vals or all(v == 0 for v in vals):
        return 1.0
    s = sum(vals)
    return s * s / (len(vals) * sum(v * v for v in vals))


@dataclass
class ServiceReport:
    """One `run()` batch: results in causal delivery order + accounting."""
    results: List[JobResult]
    makespan_s: float
    total_cost_usd: float
    total_billed_s: float
    total_invocations: int
    skipped_invocations: int
    cold_starts: int
    preempted_jobs: List[str]
    tenant_billed_s: Dict[str, float]

    @property
    def fairness(self) -> float:
        return jain_fairness(list(self.tenant_billed_s.values()))

    def latencies_s(self) -> List[float]:
        return [r.latency_s for r in self.results]

    def p95_latency_s(self) -> float:
        lats = sorted(self.latencies_s())
        if not lats:
            return 0.0
        # nearest-rank percentile: ceil(p*n)-1 (int(p*n) returns the max
        # whenever p*n is integral)
        import math
        return lats[min(len(lats) - 1,
                        max(0, math.ceil(0.95 * len(lats)) - 1))]

    def digest(self) -> str:
        """Canonical schedule digest: job identity, completion times,
        bills, and delivery order.  Seed-reproducible — two runs of the
        same submissions must produce the same digest."""
        h = hashlib.sha256()
        for r in self.results:
            h.update((f"{r.job_id}|{r.status}|{r.start_s:.6f}|"
                      f"{r.end_s:.6f}|{r.billed_seconds:.6f}|"
                      f"{r.cost_dollars:.9f}|{r.invocations}|"
                      f"{r.skipped_invocations}\n").encode())
        h.update(f"makespan={self.makespan_s:.6f}\n".encode())
        return h.hexdigest()[:16]


class BenchmarkService:
    """Multi-tenant benchmarking service facade: submit jobs, run, get
    causally ordered results.  `planner` (optional) turns deadline/budget
    asks into concrete configurations at admission time."""

    def __init__(self, cfg: Optional[ServiceConfig] = None, *,
                 planner: Optional[DeadlineCostPlanner] = None):
        self.cfg = cfg or ServiceConfig()
        self.planner = planner
        self._fleets: Dict[tuple, _Fleet] = {}
        self._submit_seq = 0
        self._queued_total = 0
        self._queued_tenant: Dict[str, int] = {}
        self.rejected: List[Tuple[str, str]] = []   # (job_id, reason)
        self.controller = None          # online re-planner (replan.py)
        if self.cfg.slo is not None:
            self._arm_slo(self.cfg.slo)

    def attach_controller(self, controller):
        """Arm an online re-plan controller (service/replan.py): it is
        consulted at admission (migrate / hedge / defer), pulsed read-only
        at delivery boundaries, and given the floor at round boundaries
        (renegotiation + preempted-job resumption).  Returns the bound
        controller."""
        self.controller = controller
        controller.bind(self)
        return controller

    @staticmethod
    def _arm_slo(slo) -> None:
        """`ServiceConfig.slo` plumbing: make sure the obs context has an
        SLOMonitor armed with the requested specs.  An existing monitor
        wins (the operator already configured one); an existing passive
        context gains a monitor sharing its registry; no context at all
        installs a full monitoring bundle."""
        from repro_torch.obs import (Observability, SLOMonitor, default_slos,
                               get_obs, load_slos, set_obs)
        obs = get_obs()
        if obs is not None and obs.monitor is not None:
            return
        if slo is True:
            specs = default_slos()
        elif isinstance(slo, str):
            specs = load_slos(slo)
        else:
            specs = list(slo)
        if obs is None:
            set_obs(Observability.monitoring(specs))
        else:
            obs.monitor = SLOMonitor(specs, metrics=obs.metrics)

    # ------------------------------------------------------------- submit
    def submit(self, job: Job, *, provider: str = "lambda",
               memory_mb: Optional[int] = None,
               memory_map: Optional[Dict[str, int]] = None,
               parallelism: Optional[int] = None,
               providers: Optional[Sequence[str]] = None) -> SubmitReceipt:
        """Admit + plan + enqueue one job.  When the job carries a
        deadline or budget and the service has a planner, the planner
        chooses (provider, memory, fleet, repeat plan) among the service's
        FaaS profiles; an infeasible ask raises AdmissionError (and is
        recorded in `rejected`) without scheduling anything."""
        from dataclasses import replace
        cfg = self.cfg
        chosen: Optional[CandidatePlan] = None
        retries: Optional[int] = None
        try:
            # cheap capacity gate first (don't plan for a full queue) ...
            check_admission(job, cfg.admission,
                            queued_total=self._queued_total,
                            queued_tenant=self._queued_tenant.get(job.tenant,
                                                                  0))
            # ... then elastic admission: while an incident is open the
            # controller may steer the job off the sick provider, arm
            # retry hedging against a timeout storm, or defer it whole
            if self.controller is not None:
                d = self.controller.admission(job, provider=provider,
                                              providers=providers)
                if d:
                    if d.get("defer"):
                        self.controller.hold(
                            job, reason=d["defer"],
                            kwargs=dict(provider=provider,
                                        memory_mb=memory_mb,
                                        memory_map=memory_map,
                                        parallelism=parallelism,
                                        providers=providers))
                        now = self._clock()
                        from repro_torch.obs import get_obs
                        obs = get_obs()
                        if obs is not None and obs.enabled:
                            obs.tracer.instant(
                                "admission_defer", cat="service", ts=now,
                                pid="tenants", tid=job.tenant,
                                args={"job": job.job_id,
                                      "reason": d["defer"]})
                            obs.metrics.inc("service.deferrals",
                                            tenant=job.tenant)
                        if obs is not None and obs.monitor is not None:
                            obs.monitor.job_event("deferred", now,
                                                  job=job.job_id,
                                                  tenant=job.tenant)
                        return SubmitReceipt(job_id=job.job_id,
                                             provider="deferred",
                                             memory_mb=0, parallelism=0,
                                             n_invocations=0)
                    provider = d.get("provider", provider)
                    providers = d.get("providers", providers)
                    retries = d.get("retries", retries)
            if (self.planner is not None
                    and (job.deadline_s is not None
                         or job.budget_usd is not None)):
                from repro_torch.service.planner import InfeasiblePlanError
                faas = tuple(p for p in (providers
                                         or self.planner.cfg.providers)
                             if p != VM_PROVIDER)
                try:
                    chosen = self.planner.plan(
                        job.workloads, deadline_s=job.deadline_s,
                        budget_usd=job.budget_usd, seed=cfg.seed,
                        providers=faas)
                except InfeasiblePlanError as exc:
                    if cfg.admission.require_feasible:
                        raise AdmissionError(job.job_id, str(exc)) from exc
            if chosen is not None and (chosen.n_calls,
                                       chosen.repeats_per_call) \
                    != (job.n_calls, job.repeats_per_call):
                # the caller's Job stays untouched (it may be resubmitted
                # elsewhere); the chosen repeat plan is re-validated
                # against the invocation cap it may have grown past
                job = replace(job, n_calls=chosen.n_calls,
                              repeats_per_call=chosen.repeats_per_call)
                check_admission(job, cfg.admission,
                                queued_total=self._queued_total,
                                queued_tenant=self._queued_tenant.get(
                                    job.tenant, 0))
        except AdmissionError as exc:
            self.rejected.append((exc.job_id, exc.reason))
            from repro_torch.obs import get_obs
            obs = get_obs()
            if obs is not None and obs.enabled:
                obs.tracer.instant("admission_reject", cat="service",
                                   ts=0.0, pid="tenants", tid=job.tenant,
                                   args={"job": exc.job_id,
                                         "reason": exc.reason})
                obs.metrics.inc("service.rejections", tenant=job.tenant)
            raise
        if chosen is not None:
            provider = chosen.provider
            memory_mb = chosen.memory_mb or cfg.memory_mb
            memory_map = chosen.memory_map_dict()
            parallelism = chosen.parallelism

        mem = memory_mb if memory_mb is not None else cfg.memory_mb
        par = parallelism if parallelism is not None else cfg.parallelism
        fleet = self._fleet(provider, par, max_retries=retries)
        backend = SimFaaSBackend(job.workloads, fleet.profile,
                                 memory_mb=mem, seed=job.seed,
                                 memory_map=memory_map)
        suite_plan = rmit.make_plan(sorted(job.workloads),
                                    n_calls=job.n_calls,
                                    repeats_per_call=job.repeats_per_call,
                                    seed=job.seed)
        ex = _JobExec(job, backend, provider, mem, self._submit_seq,
                      fleet.clock_s, len(suite_plan.invocations), chosen)
        self._submit_seq += 1
        fleet.enqueue(ex, suite_plan)
        self._queued_total += 1
        self._queued_tenant[job.tenant] = \
            self._queued_tenant.get(job.tenant, 0) + 1
        from repro_torch.obs import get_obs
        obs = get_obs()
        if obs is not None and obs.enabled:
            obs.tracer.instant(
                "admit", cat="service", ts=fleet.clock_s, pid="tenants",
                tid=job.tenant,
                args={"job": job.job_id, "provider": provider,
                      "n_invocations": len(suite_plan.invocations),
                      "planned": chosen is not None})
            obs.metrics.inc("service.jobs_submitted", tenant=job.tenant,
                            provider=provider)
        if obs is not None and obs.monitor is not None:
            obs.monitor.job_event(
                "submitted", fleet.clock_s, job=job.job_id,
                tenant=job.tenant, deadline_s=job.deadline_s,
                budget_usd=job.budget_usd)
        if self.controller is not None:
            self.controller.note_admitted(job)
        return SubmitReceipt(job_id=job.job_id, provider=provider,
                             memory_mb=mem, parallelism=par,
                             n_invocations=len(suite_plan.invocations),
                             plan=chosen)

    def _fleet(self, provider: str, parallelism: int, *,
               max_retries: Optional[int] = None) -> _Fleet:
        # the default key shape is unchanged so historical fleet
        # iteration order (and every golden digest) is preserved; only
        # an explicit retry override (controller hedging) extends it
        key = ((provider, parallelism) if max_retries is None
               else (provider, parallelism, max_retries))
        if key not in self._fleets:
            self._fleets[key] = _Fleet(provider, parallelism, self.cfg,
                                       max_retries=max_retries)
        return self._fleets[key]

    def _clock(self) -> float:
        """The service-wide virtual clock: the furthest fleet clock."""
        return max((f.clock_s for f in self._fleets.values()), default=0.0)

    # ---------------------------------------------------------------- run
    def run(self) -> ServiceReport:
        """Execute every queued job to completion (virtual time), then
        deliver results: per tenant in submission order, at delivery
        times that never precede the underlying completions."""
        if self.controller is not None:
            # round boundary, before the drain: renegotiate deadlines of
            # queued at-risk jobs and release deferred jobs whose
            # blocking incidents cleared (released jobs join this round)
            self.controller.before_round(self._clock())
        batch: List[_JobExec] = []
        for key in sorted(self._fleets):
            batch.extend(self._fleets[key].run(self.cfg, self.controller))
        for ex in batch:
            ex.result = self._job_result(ex)
            self._queued_total -= 1
            self._queued_tenant[ex.job.tenant] -= 1
        # retire delivered jobs: a long-lived service must not re-seed or
        # rescan every backend it ever saw on the next batch (the
        # _JobExec itself stays alive only through the returned results)
        for fleet in self._fleets.values():
            for jid in [j for j, ex in fleet.jobs.items()
                        if ex.result is not None]:
                del fleet.jobs[jid]
                fleet.router.backends.pop(jid, None)
                fleet.router.billed_by_job.pop(jid, None)
                fleet.router.cost_by_job.pop(jid, None)

        # causal delivery: a tenant's jobs arrive in submission order, at
        # a time >= every earlier result of that tenant (commit N+1 of a
        # pipeline can never land before commit N); across tenants,
        # deliveries interleave in virtual-time order
        deliveries: List[Tuple[float, int, _JobExec]] = []
        by_tenant: Dict[str, List[_JobExec]] = {}
        for ex in batch:
            by_tenant.setdefault(ex.job.tenant, []).append(ex)
        for tenant in sorted(by_tenant):
            t_causal = 0.0
            for ex in sorted(by_tenant[tenant], key=lambda e: e.submit_seq):
                t_causal = max(t_causal, ex.result.end_s)
                deliveries.append((t_causal, ex.submit_seq, ex))
        deliveries.sort(key=lambda d: (d[0], d[1]))

        from repro_torch.obs import get_obs
        obs = get_obs()
        on = obs is not None and obs.enabled
        tr = obs.tracer if on else None
        mx = obs.metrics if on else None
        tenant_cost: Dict[str, float] = {}
        tenant_budget: Dict[str, float] = {}

        results = []
        tenant_billed: Dict[str, float] = {}
        for t_deliver, _, ex in deliveries:
            results.append(ex.result)
            tenant_billed[ex.job.tenant] = \
                tenant_billed.get(ex.job.tenant, 0.0) + ex.billed_s
            r = ex.result
            if tr is not None:
                tr.span(r.job_id, cat="job", ts=r.start_s,
                        dur=max(0.0, r.end_s - r.start_s), pid="tenants",
                        tid=ex.job.tenant,
                        args={"status": r.status, "provider": r.provider,
                              "invocations": r.invocations,
                              "cost_usd": r.cost_dollars})
                tr.instant("deliver", cat="service", ts=t_deliver,
                           pid="tenants", tid=ex.job.tenant,
                           args={"job": r.job_id, "status": r.status})
            if mx is not None:
                mx.inc("service.cost_usd", r.cost_dollars,
                       tenant=ex.job.tenant, provider=r.provider)
                mx.inc("service.jobs_delivered", tenant=ex.job.tenant,
                       provider=r.provider)
                tenant_cost[ex.job.tenant] = \
                    tenant_cost.get(ex.job.tenant, 0.0) + r.cost_dollars
                if ex.job.budget_usd is not None:
                    tenant_budget[ex.job.tenant] = \
                        tenant_budget.get(ex.job.tenant, 0.0) \
                        + ex.job.budget_usd
            if ex.job.callback is not None:
                ex.job.callback(ex.result)
        if mx is not None:
            # cost burn-down vs budget, per tenant (jobs without budgets
            # contribute spend but no budget; gauge only where a budget
            # exists to burn)
            for tenant, budget in sorted(tenant_budget.items()):
                if budget > 0:
                    mx.set_gauge("service.budget_burn_frac",
                                 tenant_cost.get(tenant, 0.0) / budget,
                                 tenant=tenant)
        if obs is not None and obs.monitor is not None:
            obs.monitor.evaluate(
                max((r.end_s for r in results), default=0.0))

        report = ServiceReport(
            results=results,
            makespan_s=max((r.end_s for r in results), default=0.0),
            total_cost_usd=sum(r.cost_dollars for r in results),
            total_billed_s=sum(r.billed_seconds for r in results),
            total_invocations=sum(r.invocations for r in results),
            skipped_invocations=sum(r.skipped_invocations for r in results),
            cold_starts=sum(f.cold_starts for f in self._fleets.values()),
            preempted_jobs=[r.job_id for r in results if r.preempted],
            tenant_billed_s=tenant_billed)
        if self.controller is not None:
            # round boundary, after delivery: resume preempted jobs on a
            # healthier provider under renegotiated terms (the
            # continuations queue for the next run() call)
            self.controller.on_round(report, self._clock())
        return report

    # -------------------------------------------------------------- build
    def _job_result(self, ex: _JobExec) -> JobResult:
        job = ex.job
        nb = self.cfg.analysis_n_boot
        if nb is None:
            changes = analyze(ex.pairs, seed=job.seed,
                              min_results=job.min_results)
        else:
            changes = analyze(ex.pairs, seed=job.seed,
                              min_results=job.min_results, n_boot=int(nb))
        start = 0.0 if ex.start_s == float("inf") else ex.start_s
        end = max(ex.end_s, start)
        latency = end - ex.enqueue_clock_s
        failed = ex.failed | (ex.infra_failed - ex.executed)
        return JobResult(
            job_id=job.job_id, tenant=job.tenant,
            status=JOB_PREEMPTED if ex.preempted else JOB_COMPLETED,
            changes=changes,
            executed_benchmarks=sorted(ex.executed - failed),
            failed_benchmarks=sorted(failed),
            invocations=ex.n_done, skipped_invocations=ex.n_skipped,
            billed_seconds=ex.billed_s, cost_dollars=ex.cost_final,
            start_s=start, end_s=end, latency_s=latency,
            met_deadline=None if job.deadline_s is None
            else latency <= job.deadline_s,
            within_budget=None if job.budget_usd is None
            else ex.cost_final <= job.budget_usd,
            provider=ex.provider, memory_mb=ex.memory_mb,
            benchmark_invocations=dict(ex.bench_inv),
            benchmark_billed_s=dict(ex.bench_billed))
