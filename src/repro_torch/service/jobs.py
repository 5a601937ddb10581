"""Service job model + admission control.

A `Job` is one suite-run request from one tenant: the workloads to
measure, the RMIT repeat plan, and the tenant's service-level asks — a
soft priority (its share inside the tenant's weight), a virtual-time
deadline, and a billing budget.  The scheduler tags every engine
invocation with the job id (rmit.Invocation.job_id), meters billing per
job, preempts jobs that exceed their budget, and delivers a `JobResult`
back through the job's callback in causal order.

Admission control bounds the queue before any work is scheduled: a
rejected job consumes nothing.  Infeasibility (no candidate plan meets
the job's deadline/budget) is also an admission-time rejection — the
paper-shaped failure mode where CI asks for a 15-minute turnaround on a
budget no provider profile can meet must be loud, not silent.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.stats import ChangeResult

JOB_QUEUED = "queued"
JOB_REJECTED = "rejected"
JOB_COMPLETED = "completed"
JOB_PREEMPTED = "preempted"         # cancelled mid-run (budget exceeded)


class AdmissionError(Exception):
    """Raised by `BenchmarkService.submit` when a job is not admitted."""

    def __init__(self, job_id: str, reason: str):
        super().__init__(f"job {job_id!r} rejected: {reason}")
        self.job_id = job_id
        self.reason = reason


@dataclass
class Job:
    """One suite-run job.  `seed` drives the job's RMIT plan and platform
    noise, so a job replays identically regardless of what else shares
    the fleet.  `callback` receives the JobResult at delivery time."""
    job_id: str
    tenant: str
    workloads: Dict[str, object]            # name -> SimWorkload
    n_calls: int = 15
    repeats_per_call: int = 3
    priority: float = 1.0                   # WFQ weight scale inside tenant
    deadline_s: Optional[float] = None      # virtual, from service start
    budget_usd: Optional[float] = None
    seed: int = 0
    min_results: int = 10
    metadata: Dict[str, object] = field(default_factory=dict)
    callback: Optional[Callable[["JobResult"], None]] = None

    def __post_init__(self):
        if not self.workloads:
            raise ValueError(f"job {self.job_id!r} has no workloads")
        if self.priority <= 0:
            raise ValueError(f"job {self.job_id!r}: priority must be > 0")


@dataclass
class JobResult:
    """What a tenant gets back for one job."""
    job_id: str
    tenant: str
    status: str                             # completed | preempted
    changes: Dict[str, ChangeResult]
    executed_benchmarks: List[str]
    failed_benchmarks: List[str]
    invocations: int
    skipped_invocations: int
    billed_seconds: float
    cost_dollars: float
    start_s: float                          # first dispatch (virtual)
    end_s: float                            # last completion (virtual)
    latency_s: float                        # queue wait + run (virtual)
    met_deadline: Optional[bool]            # None when no deadline was set
    within_budget: Optional[bool]
    provider: str = ""
    memory_mb: int = 0
    benchmark_invocations: Dict[str, int] = field(default_factory=dict)
    benchmark_billed_s: Dict[str, float] = field(default_factory=dict)

    @property
    def preempted(self) -> bool:
        return self.status == JOB_PREEMPTED


@dataclass
class AdmissionConfig:
    """Queue-protection knobs checked before a job is accepted."""
    max_queued_jobs: int = 1024
    max_jobs_per_tenant: int = 256
    max_invocations_per_job: int = 200_000
    require_feasible: bool = True      # planner-backed jobs must have a plan


def check_admission(job: Job, cfg: AdmissionConfig, *,
                    queued_total: int, queued_tenant: int) -> None:
    """Raises AdmissionError when the job must not enter the queue."""
    if queued_total >= cfg.max_queued_jobs:
        raise AdmissionError(job.job_id,
                             f"service queue full ({cfg.max_queued_jobs})")
    if queued_tenant >= cfg.max_jobs_per_tenant:
        raise AdmissionError(
            job.job_id, f"tenant {job.tenant!r} already has "
            f"{queued_tenant} queued jobs (cap {cfg.max_jobs_per_tenant})")
    n_inv = len(job.workloads) * job.n_calls
    if n_inv > cfg.max_invocations_per_job:
        raise AdmissionError(
            job.job_id, f"job needs {n_inv} invocations "
            f"(cap {cfg.max_invocations_per_job})")
