"""Deterministic simulated cloud platforms (FaaS + VM baseline).

This container has one CPU, so the paper's *environment* — noisy,
heterogeneous, elastically scalable cloud instances — is simulated with a
virtual-time event loop.  The models follow the phenomena the paper builds
on (§3, citing [48], [8]):

  * inter-instance heterogeneity: per-instance lognormal speed factor
  * diurnal drift: sinusoidal +/- a few percent over the (virtual) day
  * cold starts: image-size-dependent container pull + init (prepopulated
    build cache => bigger image, fewer in-function compile seconds)
  * memory->compute scaling: cpu_factor = min(1, mem_mb/1769) (Lambda ARM)
  * restricted environment: workloads flagged fs_write fail (§3.2/§7.4)
  * per-benchmark 20 s timeout, 15 min function cap (§6.1)
  * warm-instance reuse up to `keep_alive_s` of idle time

Everything is a pure function of the seed: experiments replay exactly.

`SimulatedFaaS` / `SimulatedVM` are thin compatibility wrappers: the
scheduling itself (slots, warm pools, retries, accounting) lives in the
shared event-driven engine (engine.py) with the platform models plugged in
as backends (backends.py).  A `FaaSPlatformConfig` maps 1:1 onto the
Lambda-like `ProviderProfile`, so existing call sites and seeds replay
the historical results bit-for-bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.costmodel import VM_PER_HOUR
from repro_torch.core.duet import DuetPair
from repro_torch.core.rmit import SuitePlan
from repro_torch.faas.backends import (LambdaLikeBackend, ProviderProfile,
                                 SimFaaSBackend, VMBackend)
from repro_torch.faas.engine import (EngineConfig, EngineObserver, EngineReport,
                               ExecutionEngine)


@dataclass(frozen=True)
class SimWorkload:
    """An abstract microbenchmark with a known ground truth."""
    name: str
    base_seconds: float             # true v1 duration on a nominal instance
    effect_pct: float               # true v2-vs-v1 change (%, + = slower)
    run_sigma: float = 0.02         # per-run lognormal noise (benchmark-inherent)
    fs_write: bool = False          # fails in the restricted FaaS filesystem
    setup_seconds: float = 0.5      # once per instance (build-cache hit)
    unstable_pct: float = 0.0       # extra +/- uniform instability (flaky bench)
    # environment sensitivity of the *magnitude* (paper §6.2.2: magnitudes
    # depend on execution environment & toolchain version; the unreliable
    # BenchmarkAddMulti-like family even flips sign between environments)
    vm_effect_scale: float = 1.0

    def true_seconds(self, version: str, env: str = "faas") -> float:
        e = self.effect_pct * (self.vm_effect_scale if env == "vm" else 1.0)
        f = 1.0 + (e / 100.0 if version == "v2" else 0.0)
        return self.base_seconds * f


@dataclass
class FaaSPlatformConfig:
    memory_mb: int = 2048
    image_gb: float = 1.0                 # prepopulated cache makes it ~1GB
    cold_start_base_s: float = 0.4
    cold_start_per_gb_s: float = 1.5      # on-demand container loading [8]
    instance_sigma: float = 0.04          # heterogeneity between instances
    diurnal_amplitude: float = 0.07       # +/-7% over a day [48]
    diurnal_period_s: float = 86400.0
    keep_alive_s: float = 600.0
    benchmark_timeout_s: float = 20.0
    function_timeout_s: float = 900.0
    cpu_nominal_mb: float = 1769.0        # Lambda: 1 vCPU per 1769 MB
    cpu_exponent: float = 2.3             # empirical single-thread scaling
    # (paper §6.1/§6.2.4: 2048 MB -> 1.29 vCPU, 1024 MB -> 0.255 vCPU;
    # a power law through those points rather than Lambda's linear vCPU line)

    @property
    def cpu_factor(self) -> float:
        return min(1.0, (self.memory_mb / self.cpu_nominal_mb)
                   ** self.cpu_exponent)

    def to_profile(self) -> ProviderProfile:
        """The Lambda-like ProviderProfile carrying this config's knobs
        (pricing and RNG stream stay at the historical defaults)."""
        return ProviderProfile(
            name="lambda",
            cold_start_base_s=self.cold_start_base_s,
            cold_start_per_gb_s=self.cold_start_per_gb_s,
            keep_alive_s=self.keep_alive_s,
            cpu_nominal_mb=self.cpu_nominal_mb,
            cpu_exponent=self.cpu_exponent,
            instance_sigma=self.instance_sigma,
            diurnal_amplitude=self.diurnal_amplitude,
            diurnal_period_s=self.diurnal_period_s,
            benchmark_timeout_s=self.benchmark_timeout_s,
            function_timeout_s=self.function_timeout_s)


@dataclass
class SimReport:
    pairs: List[DuetPair]
    wall_seconds: float
    billed_seconds: List[float]
    cost_dollars: float
    cold_starts: int
    timeouts: int
    failures: int
    executed_benchmarks: List[str]
    failed_benchmarks: List[str]

    @classmethod
    def from_engine(cls, rep: EngineReport, *,
                    billed: Optional[List[float]] = None) -> "SimReport":
        return cls(pairs=rep.pairs, wall_seconds=rep.wall_seconds,
                   billed_seconds=rep.billed_seconds if billed is None
                   else billed,
                   cost_dollars=rep.cost_dollars,
                   cold_starts=rep.cold_starts, timeouts=rep.timeouts,
                   failures=rep.failures,
                   executed_benchmarks=rep.executed_benchmarks,
                   failed_benchmarks=rep.failed_benchmarks)


def make_provider_backend(workloads: Dict[str, SimWorkload], provider: str,
                          *, memory_mb: int = 2048, seed: int = 0,
                          start_time_s: float = 0.0, chaos=None):
    """One simulated-provider backend by name ("lambda" / "gcf" / "azure").

    The Lambda path goes through `FaaSPlatformConfig.to_profile()` — the
    historical pricing and RNG stream — so results replay the original
    `SimulatedFaaS` bit-for-bit; the other providers use their registered
    `ProviderProfile`s directly.

    `chaos` (a faas/chaos.py `ChaosConfig`) wraps the backend in the
    fault-injection layer; a zero-intensity config is an exact identity
    (conformance-tested), so callers can thread a chaos knob through
    unconditionally."""
    from repro_torch.faas.backends import PROVIDER_PROFILES
    if provider == "lambda":
        backend = SimulatedFaaS(workloads,
                                FaaSPlatformConfig(memory_mb=memory_mb),
                                seed=seed, start_time_s=start_time_s)\
            .make_backend()
    else:
        profile = PROVIDER_PROFILES[provider]
        backend = SimFaaSBackend(workloads, profile, memory_mb=memory_mb,
                                 seed=seed, start_time_s=start_time_s)
    if chaos is not None:
        from repro_torch.faas.chaos import ChaosBackend
        backend = ChaosBackend(backend, chaos)
    return backend


class SimulatedFaaS:
    """Virtual-time simulation of running a SuitePlan at a given parallelism.

    Thin wrapper: builds a Lambda-like backend from the config and delegates
    scheduling to the shared ExecutionEngine."""

    def __init__(self, workloads: Dict[str, SimWorkload],
                 cfg: Optional[FaaSPlatformConfig] = None, seed: int = 0,
                 start_time_s: float = 0.0):
        self.w = workloads
        self.cfg = cfg or FaaSPlatformConfig()
        self.seed = seed
        self.start = start_time_s

    def make_backend(self) -> SimFaaSBackend:
        return LambdaLikeBackend(
            self.w, profile=self.cfg.to_profile(),
            memory_mb=self.cfg.memory_mb, image_gb=self.cfg.image_gb,
            seed=self.seed, start_time_s=self.start)

    def run_suite(self, plan: SuitePlan, *, parallelism: int = 150,
                  observer: Optional[EngineObserver] = None,
                  engine: str = "fast") -> SimReport:
        from repro_torch.faas.engine_vec import make_engine
        eng = make_engine(self.make_backend(),
                          EngineConfig(parallelism=parallelism),
                          engine=engine)
        return SimReport.from_engine(eng.run(plan, observer=observer))


@dataclass
class VMPlatformConfig:
    """The paper's original-dataset environment [23]: sequential RMIT on a
    small set of cloud VMs, higher inter-trial variability, and a per-trial
    overhead (VM-side recompilation / RMIT re-setup)."""
    n_vms: int = 3
    instance_sigma: float = 0.05
    run_sigma_scale: float = 1.5          # VM multi-tenant noise
    diurnal_amplitude: float = 0.05
    trial_overhead_s: float = 5.0
    per_hour: float = VM_PER_HOUR


class SimulatedVM:
    """Sequential duet execution on n_vms virtual machines (the baseline the
    paper compares against; produces the 'original dataset').

    Thin wrapper over the shared engine with a pinned-instance VM backend."""

    def __init__(self, workloads: Dict[str, SimWorkload],
                 cfg: Optional[VMPlatformConfig] = None, seed: int = 1):
        self.w = workloads
        self.cfg = cfg or VMPlatformConfig()
        self.seed = seed

    def run_suite(self, plan: SuitePlan,
                  observer: Optional[EngineObserver] = None,
                  engine: str = "fast") -> SimReport:
        from repro_torch.faas.engine_vec import make_engine
        backend = VMBackend(self.w, self.cfg, seed=self.seed)
        eng = make_engine(backend, EngineConfig(parallelism=self.cfg.n_vms),
                          engine=engine)
        # the original dataset reported wall-clock VM-hours, not per-call
        # billed durations
        return SimReport.from_engine(eng.run(plan, observer=observer),
                                     billed=[])
