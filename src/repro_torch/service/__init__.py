"""Benchmarking-as-a-service (beyond-paper, Japke et al. 2025 direction).

The paper evaluates one suite for one user; its natural deployment is a
shared service many CI pipelines submit to.  This package is that service
layer, stacked on the PR-1 engine and the PR-2 pipeline:

    jobs.py       suite-run jobs (tenant, priority, deadline, budget) and
                  admission control
    queue.py      multi-tenant weighted-fair queue over one virtual-time
                  clock (WFQ: per-tenant share of the fleet, no starvation)
    planner.py    deadline/cost planner: enumerate provider x memory x
                  fleet x repeat-plan candidates, predict duration/cost
                  from the billing model + measured memory curves
                  (core/autotune.py), pick the cheapest plan meeting the
                  deadline or the fastest within budget
    scheduler.py  the service scheduler: many concurrent jobs multiplexed
                  onto per-provider engine fleets with shared warm pools,
                  over-budget preemption, and causally ordered result
                  delivery back to each tenant
    replan.py     online re-planning: the monitoring plane's alert feed
                  closed-loop into the scheduler — migration off degraded
                  providers, retry hedging under timeout storms, elastic
                  admission deferral, deadline renegotiation, and
                  resumption of preempted jobs from partial progress

Everything is deterministic: the same seed produces identical plans,
schedules, and bills (golden-digest tested).
"""
from repro_torch.service.jobs import (AdmissionConfig, AdmissionError, Job,
                                JobResult, JOB_COMPLETED, JOB_PREEMPTED,
                                JOB_QUEUED, JOB_REJECTED)
from repro_torch.service.planner import (CandidatePlan, DeadlineCostPlanner,
                                   InfeasiblePlanError, PlannerConfig,
                                   pareto_frontier)
from repro_torch.service.queue import FairQueue
from repro_torch.service.replan import ReplanConfig, ReplanController
from repro_torch.service.scheduler import (BenchmarkService, ServiceConfig,
                                     ServiceReport)

__all__ = [
    "AdmissionConfig", "AdmissionError", "Job", "JobResult",
    "JOB_COMPLETED", "JOB_PREEMPTED", "JOB_QUEUED", "JOB_REJECTED",
    "CandidatePlan", "DeadlineCostPlanner", "InfeasiblePlanError",
    "PlannerConfig", "pareto_frontier", "FairQueue",
    "ReplanConfig", "ReplanController",
    "BenchmarkService", "ServiceConfig", "ServiceReport",
]
