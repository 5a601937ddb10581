"""Online re-planning: close the control loop between the monitoring
plane (obs/slo.py, obs/incidents.py) and the service scheduler.

`ReplanController` subscribes to the live alert/anomaly stream through
`SLOMonitor.alert_feed` and turns open incidents into scheduling
actions, all on the virtual clock:

  trigger taxonomy (what opens)
    timeout_storm       timeout-rate burn SLO or timeout-window detector
                        firing on a provider fleet
    provider_degraded   error-rate burn SLO, error/latency/cold-window
                        detector firing on a provider fleet
    budget_burn_hot     a job burning budget above the sustainable rate
                        (recorded; resolution happens through preemption
                        + resumption, not mid-flight throttling)
    deadline_at_risk    a job past ``warn_frac`` of its deadline budget
                        (recorded; resolution is renegotiation below)

  action vocabulary (what the controller does about it)
    migrate       at admission: a planner-managed job is steered to the
                  healthy subset of its allowed providers — never *to* a
                  provider with an open trigger
    hedge         at admission: an unmanaged job pinned to a stormy
                  provider runs on a retry-hedged fleet (transient
                  timeouts are retried instead of surfacing as failures)
    defer         elastic admission: a job with no healthy placement is
                  held while the incident is open and resubmitted once
                  it clears (or after ``max_defer_rounds`` rounds)
    renegotiate   at round boundaries: a queued job whose measured
                  provider slowdown predicts a deadline miss gets a new
                  deadline, recorded as a ``deadline_renegotiated``
                  event — the SLO plane tracks the new terms instead of
                  hard-breaching the old ones
    resume        at round boundaries: a budget-preempted job's
                  remaining benchmarks are re-planned through
                  `DeadlineCostPlanner.replan` (billed cost and
                  completed benchmarks are sunk, measured per-provider
                  slowdowns re-price the candidates) and resubmitted on
                  a healthier provider under renegotiated terms —
                  instead of hard-killing the job
    grow/shrink   implicit in both planning paths: candidates span the
                  fleet-width grid, so pressure (a tight remaining
                  deadline) selects wider fleets and calm selects
                  cheaper narrow ones

Determinism contract — the hard invariant the tests pin: the controller
is strictly *read-only* between round boundaries.  Delivery-time pulses
only advance the monitor and the controller's trigger state (derived
exclusively from the cadence-invariant alert stream: windowed rate SLOs
and detector events, which are property-tested to be identical however
drains are scheduled).  Every action commits either at admission time or
at a round boundary.  With the controller armed but no trigger fired
(zero chaos, calm SLOs) every schedule therefore replays bit-for-bit.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.service.jobs import AdmissionError, Job
from repro_torch.service.planner import InfeasiblePlanError, VM_PROVIDER

# alert-stream signals that open provider-scoped triggers.  Only
# cadence-invariant signals qualify (windowed burn-rate SLOs + windowed
# detector series): now-dependent evaluators (deadline, p99) may stamp
# different times under different pulse cadences, so acting on them
# would let the engine choice leak into the schedule.
_STORM_SLO = ("timeout_rate",)
_STORM_SERIES = ("engine.win.timeout",)
_DEGRADE_SLO = ("error_rate", "cold_start_rate")
_DEGRADE_SERIES = ("engine.win.err", "engine.win.latency",
                   "engine.win.cold")


@dataclass
class ReplanConfig:
    migrate: bool = True                # steer managed jobs off sick fleets
    hedge: bool = True                  # retry-hedge unmanaged storm jobs
    hedge_retries: int = 2
    defer_new_jobs: bool = True         # elastic admission while incidents
    max_defer_rounds: int = 2           #   are open; forced release after
    renegotiate: bool = True            # new deadlines over hard breaches
    resume_preempted: bool = True       # continuations over hard kills
    margin: float = 1.25                # headroom on renegotiated deadlines
    budget_topup_frac: float = 0.5      # resumption top-up as a fraction of
    #                                     the original budget (the
    #                                     renegotiated terms a tenant would
    #                                     accept to finish a paid-for job)
    pulse_interval_s: float = 60.0      # min virtual time between mid-run
    #                                     monitor evaluations (one window)
    slowdown_windows: int = 4           # ring windows for the measured
    #                                     slowdown baseline/recent means


@dataclass
class _Held:
    job: Job
    kwargs: dict
    reason: str
    blocked_on: Tuple[str, ...]
    rounds: int = 0


class ReplanController:
    """The online re-planner.  Attach with
    ``service.attach_controller(ReplanController())``."""

    def __init__(self, cfg: Optional[ReplanConfig] = None):
        self.cfg = cfg or ReplanConfig()
        self.service = None
        self.events: List[dict] = []    # virtual-time action/trigger log
        self.held: List[_Held] = []
        self._mon = None
        self._cursor: Tuple[int, int] = (0, 0)
        self._open: Dict[tuple, Tuple[str, str]] = {}   # feed key ->
        #                                                 (trigger, provider)
        self._jobs: Dict[str, Job] = {}     # originals seen at admission
        self._resumed: set = set()
        self._releasing = False
        self._last_pulse = float("-inf")

    # ------------------------------------------------------------- wiring
    def bind(self, service) -> None:
        self.service = service
        from repro_torch.obs import get_obs
        obs = get_obs()
        self._mon = obs.monitor if obs is not None else None

    def _record(self, event: str, t: float, **fields) -> None:
        row = {"event": event, "t": float(t)}
        row.update(fields)
        self.events.append(row)
        from repro_torch.obs import get_obs
        obs = get_obs()
        if obs is not None and obs.enabled:
            obs.tracer.instant(f"replan.{event}", cat="replan", ts=t,
                               pid="replan", tid="controller", args=fields)
            obs.metrics.inc(f"replan.{event}")

    # ----------------------------------------------------- trigger state
    @staticmethod
    def _classify(row: dict) -> Optional[Tuple[str, str]]:
        """(trigger, provider) for provider-scoped trigger rows; None for
        everything else."""
        prov = (row.get("labels") or {}).get("provider")
        if not prov:
            return None
        kind, series = row.get("kind"), row.get("series")
        if kind in _STORM_SLO or series in _STORM_SERIES:
            return "timeout_storm", prov
        if kind in _DEGRADE_SLO or series in _DEGRADE_SERIES:
            return "provider_degraded", prov
        return None

    def _ingest(self) -> None:
        """Fold fresh alert-feed rows into the open-trigger table.  The
        feed is cumulative and cursor-based, so ingestion frequency never
        changes the resulting state."""
        if self._mon is None:
            return
        rows, self._cursor = self._mon.alert_feed(self._cursor)
        for row in rows:
            state = row.get("state")
            lb = row.get("labels") or {}
            if row.get("kind") == "budget_burn" and state == "fire":
                self._record("trigger_open", row["t"],
                             trigger="budget_burn_hot",
                             job=lb.get("job"), tenant=lb.get("tenant"))
                continue
            if row.get("kind") == "deadline" and state == "fire":
                self._record("trigger_open", row["t"],
                             trigger="deadline_at_risk",
                             job=lb.get("job"), tenant=lb.get("tenant"))
                continue
            cls = self._classify(row)
            if cls is None:
                continue
            key = (row.get("slo") or row.get("detector"),
                   tuple(sorted(lb.items())), row.get("series"))
            if state == "fire" and key not in self._open:
                self._open[key] = cls
                self._record("trigger_open", row["t"], trigger=cls[0],
                             provider=cls[1],
                             signal=row.get("slo") or row.get("detector"))
            elif state == "clear" and key in self._open:
                del self._open[key]
                self._record("trigger_clear", row["t"], trigger=cls[0],
                             provider=cls[1],
                             signal=row.get("slo") or row.get("detector"))

    def sick_providers(self) -> set:
        return {prov for _, prov in self._open.values()}

    def storm_providers(self) -> set:
        return {prov for trig, prov in self._open.values()
                if trig == "timeout_storm"}

    def open_incidents(self) -> List[dict]:
        """Incident records (obs/incidents.py) still open right now —
        the admission-deferral justification artifact."""
        from repro_torch.obs import get_obs
        obs = get_obs()
        if obs is None or obs.monitor is None:
            return []
        return [inc for inc in obs.incidents() if inc.get("open")]

    # ------------------------------------------------------------- pulse
    def pulse(self, provider: str, t: float) -> None:
        """Read-only delivery-boundary hook from the fleet observer:
        advance the monitor on the virtual clock and refresh trigger
        state.  Never mutates the schedule."""
        if self._mon is None:
            return
        if t - self._last_pulse < self.cfg.pulse_interval_s:
            return
        self._last_pulse = t
        self._mon.evaluate(t)
        self._ingest()

    # --------------------------------------------------------- admission
    def admission(self, job: Job, *, provider: str,
                  providers: Optional[Sequence[str]]) -> Optional[dict]:
        """Elastic-admission consult from `BenchmarkService.submit`.
        Returns None (no perturbation) or a directive dict:
        ``{"providers": (...)}`` / ``{"provider": p}`` to migrate,
        ``{"retries": n}`` to hedge, ``{"defer": reason}`` to hold."""
        self._ingest()
        if (job.metadata or {}).get("pin"):
            return None                 # pinned canaries ride the storm
        sick = self.sick_providers()
        if not sick:
            return None
        managed = (self.service.planner is not None
                   and (job.deadline_s is not None
                        or job.budget_usd is not None))
        if managed:
            allowed = tuple(p for p in (providers
                                        or self.service.planner.cfg.providers)
                            if p != VM_PROVIDER)
            healthy = tuple(p for p in allowed if p not in sick)
            if healthy == allowed:
                return None             # nothing to steer around
            if healthy and self.cfg.migrate:
                self._record("migrate", self.service._clock(),
                             job=job.job_id, away_from=sorted(
                                 set(allowed) & sick),
                             to=list(healthy))
                return {"providers": healthy}
            if self.cfg.defer_new_jobs and not self._releasing:
                return {"defer": "no healthy provider: "
                                 + ", ".join(sorted(sick))}
            return None
        # unmanaged job pinned to a specific fleet
        if provider in self.storm_providers() and self.cfg.hedge:
            self._record("hedge", self.service._clock(), job=job.job_id,
                         provider=provider, retries=self.cfg.hedge_retries)
            return {"retries": self.cfg.hedge_retries}
        if (provider in sick and self.cfg.defer_new_jobs
                and not self._releasing):
            return {"defer": f"incident open on {provider}"}
        return None

    def hold(self, job: Job, *, reason: str, kwargs: dict) -> None:
        self.held.append(_Held(job=job, kwargs=kwargs, reason=reason,
                               blocked_on=tuple(sorted(
                                   self.sick_providers()))))
        self._record("defer", self.service._clock(), job=job.job_id,
                     reason=reason)

    # ----------------------------------------------------- round boundary
    def before_round(self, now: float) -> None:
        """Pre-drain round hook: renegotiate queued at-risk deadlines and
        release deferred jobs whose incidents cleared (or timed out)."""
        if self._mon is not None:
            self._mon.evaluate(now)
        self._ingest()
        sick = self.sick_providers()
        if self.cfg.renegotiate and sick:
            self._renegotiate_queued(now, sick)
        if self.held:
            self._release_held(now, sick)

    def _renegotiate_queued(self, now: float, sick: set) -> None:
        cfg = self.cfg
        for key in sorted(self.service._fleets):
            fleet = self.service._fleets[key]
            if fleet.provider not in sick:
                continue
            f = self.measured_slowdown(fleet.provider)
            if f <= 1.0:
                continue
            for jid in sorted(fleet.jobs):
                ex = fleet.jobs[jid]
                job = ex.job
                if (ex.result is not None or ex.n_done
                        or job.deadline_s is None
                        or (job.metadata or {}).get("pin")):
                    continue
                base = (ex.plan.predicted_wall_s if ex.plan is not None
                        else job.deadline_s)
                need = cfg.margin * f * base
                if need <= job.deadline_s:
                    continue
                old = job.deadline_s
                ex.job = replace(job, deadline_s=need)
                self._record("deadline_renegotiated", now, job=jid,
                             tenant=job.tenant, old_deadline_s=old,
                             deadline_s=need, slowdown=f,
                             provider=fleet.provider)
                if self._mon is not None:
                    self._mon.job_event("deadline_renegotiated", now,
                                        job=jid, tenant=job.tenant,
                                        deadline_s=need,
                                        old_deadline_s=old)

    def _release_held(self, now: float, sick: set) -> None:
        still: List[_Held] = []
        ready: List[_Held] = []
        for h in self.held:
            h.rounds += 1
            blocked = any(p in sick for p in h.blocked_on)
            if not blocked or h.rounds >= self.cfg.max_defer_rounds:
                ready.append(h)
            else:
                still.append(h)
        self.held = still
        self._releasing = True
        try:
            for h in ready:
                self._record("release", now, job=h.job.job_id,
                             held_rounds=h.rounds)
                try:
                    self.service.submit(h.job, **h.kwargs)
                except AdmissionError:
                    pass                # recorded in service.rejected
        finally:
            self._releasing = False

    def on_round(self, report, now: float) -> None:
        """Post-delivery round hook: resume preempted jobs under
        renegotiated terms on a healthier provider."""
        self._ingest()
        if not self.cfg.resume_preempted:
            return
        for r in report.results:
            if not r.preempted or r.job_id in self._resumed:
                continue
            if "~r" in r.job_id:
                continue                # one resumption per original job
            job = self._jobs.get(r.job_id)
            if job is None or (job.metadata or {}).get("no_resume"):
                continue
            self._resumed.add(r.job_id)
            self._resume(job, r, now)

    def note_admitted(self, job: Job) -> None:
        """Service-side registration of an admitted job (needed to
        rebuild its remaining suite on resumption)."""
        self._jobs[job.job_id] = job

    def _resume(self, job: Job, r, now: float) -> None:
        planner = self.service.planner
        if planner is None:
            return
        done = set(r.executed_benchmarks)
        remaining = {n: w for n, w in job.workloads.items()
                     if n not in done}
        if not remaining:
            # billing crossed after the last benchmark executed: the
            # tenant already has full results, nothing to re-plan
            self._record("resume_noop", now, job=r.job_id,
                         reason="all benchmarks executed before "
                                "preemption")
            return
        cfg = self.cfg
        sick = self.sick_providers()
        allowed = tuple(p for p in planner.cfg.providers
                        if p != VM_PROVIDER and p not in sick) \
            or tuple(p for p in planner.cfg.providers if p != VM_PROVIDER)
        slow = {p: self.measured_slowdown(p) for p in allowed}
        # renegotiated budget: the tenant keeps what it paid for by
        # topping the original budget up (sunk cost stays sunk)
        budget = job.budget_usd
        if budget is not None:
            budget = max(budget,
                         r.cost_dollars + cfg.budget_topup_frac * budget)
        try:
            chosen = planner.replan(
                job.workloads, completed=sorted(done),
                spent_usd=r.cost_dollars, elapsed_s=r.latency_s,
                deadline_s=job.deadline_s, budget_usd=budget,
                seed=self.service.cfg.seed, providers=allowed,
                slowdown=slow)
        except InfeasiblePlanError:
            try:
                # the original terms are lost: re-plan unconstrained for
                # the cheapest continuation and renegotiate both the
                # deadline and the budget around it below
                chosen = planner.replan(
                    job.workloads, completed=sorted(done),
                    spent_usd=r.cost_dollars, elapsed_s=r.latency_s,
                    deadline_s=None, budget_usd=None,
                    seed=self.service.cfg.seed, providers=allowed,
                    slowdown=slow)
            except InfeasiblePlanError:
                self._record("resume_failed", now, job=r.job_id,
                             reason="no feasible continuation")
                return
        rem_deadline = (None if job.deadline_s is None
                        else max(0.0, job.deadline_s - r.latency_s))
        new_deadline = rem_deadline
        if rem_deadline is not None \
                and chosen.predicted_wall_s > rem_deadline:
            new_deadline = cfg.margin * chosen.predicted_wall_s
        rem_budget = (None if budget is None
                      else max(0.0, budget - r.cost_dollars))
        if rem_budget is not None \
                and chosen.predicted_cost_usd > rem_budget:
            # the negotiated terms: finishing costs what it costs, plus
            # headroom — recorded so the artifact shows the top-up
            rem_budget = cfg.margin * chosen.predicted_cost_usd
        cont = replace(
            job, job_id=f"{r.job_id}~r", workloads=remaining,
            deadline_s=new_deadline, budget_usd=rem_budget,
            metadata={**(job.metadata or {}), "resumed_from": r.job_id,
                      "pin": True})
        if new_deadline != rem_deadline:
            self._record("deadline_renegotiated", now, job=cont.job_id,
                         tenant=job.tenant, old_deadline_s=rem_deadline,
                         deadline_s=new_deadline,
                         provider=chosen.provider)
            if self._mon is not None:
                self._mon.job_event("deadline_renegotiated", now,
                                    job=cont.job_id, tenant=job.tenant,
                                    deadline_s=new_deadline,
                                    old_deadline_s=rem_deadline)
        try:
            self.service.submit(cont, providers=(chosen.provider,))
        except AdmissionError:
            self._record("resume_failed", now, job=r.job_id,
                         reason="continuation rejected")
            return
        self._record("resume", now, job=r.job_id,
                     continuation=cont.job_id, provider=chosen.provider,
                     remaining=len(remaining), sunk_usd=r.cost_dollars,
                     plan=chosen.label)

    # --------------------------------------------------------- telemetry
    def measured_slowdown(self, provider: str) -> float:
        """First-order live recalibration: mean windowed latency of the
        most recent ``slowdown_windows`` windows over the earliest ones
        still in the ring.  1.0 when there is no evidence either way.
        Reads only the windowed rings, which are bit-identical under
        scalar and vectorized feeding (chunking-invariance property)."""
        if self._mon is None:
            return 1.0
        for labels, ring in self._mon.metrics.window_series(
                "engine.win.latency"):
            if labels.get("provider") != provider:
                continue
            idx = ring.window_indices()
            k = self.cfg.slowdown_windows
            if len(idx) < 2 * k:
                return 1.0

            def mean(ws):
                c = s = 0.0
                for w in ws:
                    agg = ring.aggregate(w)
                    if agg is not None:
                        c += agg[0]
                        s += agg[1]
                return s / c if c else 0.0

            base, recent = mean(idx[:k]), mean(idx[-k:])
            if base <= 0.0 or recent <= 0.0:
                return 1.0
            return max(1.0, recent / base)
        return 1.0

    def summary(self) -> dict:
        by_type: Dict[str, int] = {}
        for ev in self.events:
            by_type[ev["event"]] = by_type.get(ev["event"], 0) + 1
        return {"events": list(self.events),
                "by_type": dict(sorted(by_type.items())),
                "open_triggers": sorted(
                    {f"{t}:{p}" for t, p in self._open.values()}),
                "held_jobs": [h.job.job_id for h in self.held],
                "resumed_jobs": sorted(self._resumed)}


__all__ = ["ReplanConfig", "ReplanController"]
