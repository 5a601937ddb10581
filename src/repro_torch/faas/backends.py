"""Pluggable platform backends for the execution engine (engine.py).

A `PlatformBackend` encapsulates *what a platform does*: how instances are
provisioned (cold-start model), how fast they run (memory→vCPU curve,
heterogeneity, diurnal drift), how long they stay warm, what fails, and
what everything costs.  The engine encapsulates *when things run*.

Simulated FaaS providers share one model (`SimFaaSBackend`) parameterized
by a `ProviderProfile` — the knobs mirror the SeBS multi-provider matrix
(Copik et al., Middleware '21): AWS-Lambda-like, Google-Cloud-Functions-
like, and Azure-Functions-like profiles differ in cold-start latency,
keep-alive, memory→vCPU scaling, pricing model, and infra failure rate.
`VMBackend` reproduces the paper's sequential VM baseline ("original
dataset"), and `LocalDuetBackend` executes real duets on host threads
(the old ElasticController path).

Backend protocol (duck-typed):

    realtime: bool              # thread-pool execution vs virtual time
    pinned: bool                # fixed fleet (instance per slot) vs elastic
    keep_alive_s: float         # warm-pool reaping horizon (elastic only)
    begin_run(parallelism)      # reset per-run state (RNG streams, ids)
    spawn_instance(inv, t, slot) -> (Instance, cold_overhead_s)
    simulate(inv, instance, t, overhead_s) -> InvocationOutcome   # virtual
    execute(inv) -> List[DuetPair]                                # realtime
    finalize(billed_seconds, wall_seconds) -> cost_dollars
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.costmodel import (AZURE_GB_SECOND, AZURE_PER_REQUEST,
                                  GCF_GB_SECOND, GCF_GHZ_SECOND,
                                  GCF_PER_REQUEST, LAMBDA_GB_SECOND,
                                  LAMBDA_PER_REQUEST)
from repro_torch.core.duet import DuetPair, DuetRunnable
from repro_torch.core.rmit import Invocation
from repro_torch.faas.engine import Instance, InvocationOutcome


# ----------------------------------------------------------------- profiles
@dataclass(frozen=True)
class ProviderProfile:
    """Everything that distinguishes one FaaS provider from another."""
    name: str
    # cold starts: image pull + runtime init, scaling with image size
    cold_start_base_s: float = 0.4
    cold_start_per_gb_s: float = 1.5
    keep_alive_s: float = 600.0
    # memory -> vCPU share: cpu = min(1, (mem/nominal)^exponent)
    cpu_nominal_mb: float = 1769.0
    cpu_exponent: float = 2.3
    # environment noise
    instance_sigma: float = 0.04
    diurnal_amplitude: float = 0.07
    diurnal_period_s: float = 86400.0
    # execution limits
    benchmark_timeout_s: float = 20.0
    function_timeout_s: float = 900.0
    # pricing
    per_gb_second: float = LAMBDA_GB_SECOND
    per_request: float = LAMBDA_PER_REQUEST
    per_ghz_second: float = 0.0          # GCF prices CPU separately
    cpu_base_ghz: float = 0.0
    billing_granularity_s: float = 0.0   # billed duration rounded up
    min_billed_s: float = 0.0
    # transient platform failures (insufficient capacity, sandbox errors)
    failure_rate: float = 0.0
    # RNG stream tag — Lambda keeps the historical stream ([seed, 7]) so
    # refactored runs replay the original SimulatedFaaS bit-for-bit
    rng_tag: int = 7

    # ----- memory-parameterized platform model (pure, planner-callable):
    # everything the deadline/cost planner needs to predict a candidate
    # configuration without instantiating a backend.
    def cpu_share(self, memory_mb: float) -> float:
        """Fraction of a vCPU a function gets at this memory size."""
        return min(1.0, (memory_mb / self.cpu_nominal_mb)
                   ** self.cpu_exponent)

    def cold_overhead_s(self, image_gb: float) -> float:
        """Container pull + runtime init for one cold start."""
        return self.cold_start_base_s + self.cold_start_per_gb_s * image_gb

    def round_billed(self, billed_s: float) -> float:
        """One invocation's billed duration after granularity/minimum."""
        g, m = self.billing_granularity_s, self.min_billed_s
        b = max(billed_s, m)
        return math.ceil(b / g) * g if g else b

    def billed_cost(self, billed_seconds: Sequence[float],
                    memory_mb: float) -> float:
        """Total bill for a list of invocation durations at one memory
        size: GB-s + per-request (+ GHz-s where the provider prices CPU
        separately)."""
        if self.billing_granularity_s or self.min_billed_s:
            total = float(sum(self.round_billed(b) for b in billed_seconds))
        else:
            total = float(sum(billed_seconds))
        cost = (total * memory_mb / 1024.0 * self.per_gb_second
                + len(billed_seconds) * self.per_request)
        if self.per_ghz_second:
            cost += (total * self.cpu_base_ghz * self.cpu_share(memory_mb)
                     * self.per_ghz_second)
        return cost


LAMBDA_PROFILE = ProviderProfile(name="lambda")

GCF_PROFILE = ProviderProfile(
    name="gcf",
    cold_start_base_s=2.0, cold_start_per_gb_s=2.8, keep_alive_s=900.0,
    cpu_nominal_mb=2048.0, cpu_exponent=1.0,       # MHz tiers ~linear in mem
    instance_sigma=0.06,
    per_gb_second=GCF_GB_SECOND, per_request=GCF_PER_REQUEST,
    per_ghz_second=GCF_GHZ_SECOND, cpu_base_ghz=2.4,
    billing_granularity_s=0.1,                     # rounds up to 100 ms
    failure_rate=0.002, rng_tag=17)

AZURE_PROFILE = ProviderProfile(
    name="azure",
    cold_start_base_s=3.5, cold_start_per_gb_s=4.5, keep_alive_s=1200.0,
    cpu_nominal_mb=1536.0, cpu_exponent=0.0,       # full vCPU at any memory
    instance_sigma=0.08,
    per_gb_second=AZURE_GB_SECOND, per_request=AZURE_PER_REQUEST,
    billing_granularity_s=0.001, min_billed_s=0.1,
    failure_rate=0.004, rng_tag=23)

PROVIDER_PROFILES: Dict[str, ProviderProfile] = {
    "lambda": LAMBDA_PROFILE,
    "gcf": GCF_PROFILE,
    "azure": AZURE_PROFILE,
}


# ------------------------------------------------------- simulated backends
class SimFaaSBackend:
    """Virtual-time FaaS provider model (elastic warm pool, cold starts,
    restricted filesystem, per-benchmark/function timeouts, GB-s billing).

    `memory_map` optionally right-sizes individual benchmarks (the
    autotuner's output): a mapped benchmark runs — and is billed — at its
    own memory size; unmapped benchmarks use the uniform `memory_mb`.
    Execution speed scales through the profile's memory→vCPU curve, so an
    under-sized benchmark can hit the 20 s timeout exactly as on the real
    platform (paper §7.1's caution)."""

    realtime = False
    pinned = False

    def __init__(self, workloads: Dict[str, "SimWorkload"],
                 profile: ProviderProfile = LAMBDA_PROFILE, *,
                 memory_mb: int = 2048, image_gb: float = 1.0,
                 seed: int = 0, start_time_s: float = 0.0,
                 memory_map: Optional[Dict[str, int]] = None):
        self.workloads = workloads
        self.profile = profile
        self.memory_mb = memory_mb
        self.image_gb = image_gb
        self.seed = seed
        self.start = start_time_s
        self.memory_map = memory_map
        self._rng: Optional[np.random.Generator] = None
        self._inst_counter = 0
        self._sim_mem: List[float] = []     # memory per simulate() call,
        #                                     aligned with the billed list

    @property
    def keep_alive_s(self) -> float:
        return self.profile.keep_alive_s

    @property
    def cpu_factor(self) -> float:
        return self.profile.cpu_share(self.memory_mb)

    def memory_for(self, benchmark: str) -> float:
        if self.memory_map is None:
            return self.memory_mb
        return self.memory_map.get(benchmark, self.memory_mb)

    def begin_run(self, parallelism: int) -> None:
        self._rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.profile.rng_tag]))
        self._inst_counter = 0
        self._sim_mem = []

    def _diurnal(self, t: float) -> float:
        p = self.profile
        return 1.0 + p.diurnal_amplitude * math.sin(
            2 * math.pi * (self.start + t) / p.diurnal_period_s)

    def spawn_instance(self, inv: Invocation, t: float,
                       slot: int) -> tuple:
        p = self.profile
        wl = self.workloads[inv.benchmark]
        self._inst_counter += 1
        speed = float(self._rng.lognormal(0.0, p.instance_sigma))
        overhead = (p.cold_start_base_s + p.cold_start_per_gb_s * self.image_gb
                    + wl.setup_seconds)
        return Instance(f"i{self._inst_counter}", speed), overhead

    def simulate(self, inv: Invocation, instance: Instance, t: float,
                 overhead_s: float) -> InvocationOutcome:
        p = self.profile
        rng = self._rng
        wl = self.workloads[inv.benchmark]
        cpu_factor = self.cpu_factor
        if self.memory_map is not None:
            mem = self.memory_for(inv.benchmark)
            cpu_factor = p.cpu_share(mem)
            self._sim_mem.append(mem)   # one entry per simulate call: the
            #                             engine bills in the same order
        dur = overhead_s
        cold = overhead_s > 0
        if p.failure_rate > 0.0 and float(rng.random()) < p.failure_rate:
            # transient sandbox/capacity error before user code runs
            return InvocationOutcome([], dur + 0.05, ok=False,
                                     platform_failure=True)
        if wl.fs_write:
            return InvocationOutcome([], dur + 0.1, ok=False,
                                     benchmark_failure=True)
        # batched noise: the whole invocation's lognormal draws in one RNG
        # call instead of one Python-level call per timing.  Filling an
        # array consumes the bit stream exactly like repeated scalar draws,
        # so the simulation replays the historical per-draw stream
        # bit-for-bit; on an early break (timeout) the state is rewound and
        # re-advanced by only the draws the scalar path would have used.
        # Unstable workloads interleave uniform draws per timing and keep
        # the scalar path.
        batched = not wl.unstable_pct
        if batched:
            state = rng.bit_generator.state
            noise_vec = rng.lognormal(0.0, wl.run_sigma,
                                      size=2 * len(inv.version_order))
        used = 0
        ok = True
        timed_out = False
        out_pairs: List[DuetPair] = []
        for order in inv.version_order:
            res = {}
            for ver in order:
                if batched:
                    noise = float(noise_vec[used])
                    used += 1
                else:
                    noise = float(rng.lognormal(0.0, wl.run_sigma))
                    noise *= 1.0 + float(rng.uniform(-wl.unstable_pct,
                                                     wl.unstable_pct)) / 100.0
                secs = (wl.true_seconds(ver) * noise * instance.speed
                        * self._diurnal(t + dur) / cpu_factor)
                if secs > p.benchmark_timeout_s:
                    ok = False
                    timed_out = True
                    dur += p.benchmark_timeout_s
                    break
                res[ver] = secs
                dur += secs
            if not ok or dur > p.function_timeout_s:
                ok = ok and dur <= p.function_timeout_s
                break
            out_pairs.append(DuetPair(
                benchmark=wl.name, v1_seconds=res["v1"],
                v2_seconds=res["v2"], instance_id=instance.iid,
                call_index=inv.call_index, cold_start=cold))
        if batched and used < len(noise_vec):
            # early break: rewind and consume exactly what the historical
            # scalar path would have, keeping later invocations aligned
            rng.bit_generator.state = state
            if used:
                rng.lognormal(0.0, wl.run_sigma, size=used)
        return InvocationOutcome(out_pairs, dur, ok=ok, timed_out=timed_out)

    def finalize(self, billed_seconds: List[float],
                 wall_seconds: float) -> float:
        p = self.profile
        if self.memory_map is not None \
                and len(self._sim_mem) == len(billed_seconds):
            # per-invocation memory: price each bill at the memory the
            # invocation actually ran with (the engine bills in simulate
            # order, so the two lists are aligned)
            return float(sum(p.billed_cost([b], mem)
                             for b, mem in zip(billed_seconds,
                                               self._sim_mem)))
        return p.billed_cost(billed_seconds, self.memory_mb)

    def finalize_batch(self, billed: np.ndarray,
                       wall_seconds: float) -> float:
        """Array equivalent of `finalize` for the vectorized engine's
        uniform-memory path.  Bit-identical arithmetic: the ceil values
        are exact integers below 2**53 either way, and the final sum runs
        left-to-right over Python floats exactly like the scalar
        generator sum inside `billed_cost`."""
        p = self.profile
        g, m = p.billing_granularity_s, p.min_billed_s
        if g or m:
            b = np.maximum(billed, m)
            if g:
                b = np.ceil(b / g) * g
            total = float(sum(b.tolist()))
        else:
            total = float(sum(billed.tolist()))
        cost = (total * self.memory_mb / 1024.0 * p.per_gb_second
                + billed.shape[0] * p.per_request)
        if p.per_ghz_second:
            cost += (total * p.cpu_base_ghz * p.cpu_share(self.memory_mb)
                     * p.per_ghz_second)
        return cost


class LambdaLikeBackend(SimFaaSBackend):
    """AWS-Lambda-like profile; the historical default platform model."""

    def __init__(self, workloads, **kw):
        kw.setdefault("profile", LAMBDA_PROFILE)
        super().__init__(workloads, **kw)


class GCFLikeBackend(SimFaaSBackend):
    """Google-Cloud-Functions-like profile: slower cold starts, GB-s +
    GHz-s pricing with 100 ms rounding, ~linear memory→CPU tiers."""

    def __init__(self, workloads, **kw):
        kw.setdefault("profile", GCF_PROFILE)
        super().__init__(workloads, **kw)


class AzureLikeBackend(SimFaaSBackend):
    """Azure-Functions-consumption-like profile: longest cold starts and
    keep-alive, full vCPU regardless of memory, 100 ms minimum bill."""

    def __init__(self, workloads, **kw):
        kw.setdefault("profile", AZURE_PROFILE)
        super().__init__(workloads, **kw)


class VMBackend:
    """The paper's original-dataset environment: a small fixed fleet of
    cloud VMs running duets sequentially, with higher multi-tenant noise
    and a per-trial overhead.  Instances are pinned one-per-slot."""

    realtime = False
    pinned = True
    keep_alive_s = math.inf

    def __init__(self, workloads: Dict[str, "SimWorkload"], cfg=None,
                 seed: int = 1):
        from repro_torch.faas.platform import VMPlatformConfig
        self.workloads = workloads
        self.cfg = cfg or VMPlatformConfig()
        self.seed = seed
        self._rng: Optional[np.random.Generator] = None
        self._vm_speed: Optional[np.ndarray] = None

    def begin_run(self, parallelism: int) -> None:
        c = self.cfg
        self._rng = np.random.default_rng(np.random.SeedSequence([self.seed,
                                                                  13]))
        self._vm_speed = self._rng.lognormal(0.0, c.instance_sigma,
                                             size=c.n_vms)

    def spawn_instance(self, inv: Invocation, t: float, slot: int) -> tuple:
        return Instance(f"vm{slot}", float(self._vm_speed[slot])), 0.0

    def simulate(self, inv: Invocation, instance: Instance, t: float,
                 overhead_s: float) -> InvocationOutcome:
        c = self.cfg
        rng = self._rng
        wl = self.workloads[inv.benchmark]
        dur = c.trial_overhead_s
        # one batched draw per invocation (stream-identical to the scalar
        # per-timing draws; no early exits here, so no rewind needed)
        batched = not wl.unstable_pct
        if batched:
            noise_vec = rng.lognormal(0.0, wl.run_sigma * c.run_sigma_scale,
                                      size=2 * len(inv.version_order))
        used = 0
        out_pairs: List[DuetPair] = []
        for order in inv.version_order:
            res = {}
            for ver in order:
                if batched:
                    noise = float(noise_vec[used])
                    used += 1
                else:
                    noise = float(rng.lognormal(0.0, wl.run_sigma
                                                * c.run_sigma_scale))
                    noise *= 1.0 + float(rng.uniform(-wl.unstable_pct,
                                                     wl.unstable_pct)) / 100.0
                drift = 1.0 + c.diurnal_amplitude * math.sin(
                    2 * math.pi * (t + dur) / 86400.0)
                secs = (wl.true_seconds(ver, env="vm") * noise
                        * instance.speed * drift)
                res[ver] = secs
                dur += secs
            out_pairs.append(DuetPair(
                benchmark=wl.name, v1_seconds=res["v1"],
                v2_seconds=res["v2"], instance_id=instance.iid,
                call_index=inv.call_index))
        return InvocationOutcome(out_pairs, dur, ok=True)

    def finalize(self, billed_seconds: List[float],
                 wall_seconds: float) -> float:
        c = self.cfg
        return wall_seconds / 3600.0 * c.per_hour * c.n_vms

    def finalize_batch(self, billed: np.ndarray,
                       wall_seconds: float) -> float:
        return self.finalize([], wall_seconds)


# -------------------------------------------------------- realtime backend
class LocalDuetBackend:
    """Executes real DuetRunnables on host threads (the old
    ElasticController path: PyTorch duets on the CUDA card, or on the
    host CPU when a suite asks for it).  The engine supplies parallelism, retries, and hedging."""

    realtime = True
    pinned = False
    keep_alive_s = math.inf

    def __init__(self, duets: Dict[str, DuetRunnable], *,
                 benchmark_timeout_s: float = 20.0,
                 invocation_timeout_s: float = 900.0):
        self.duets = duets
        self.benchmark_timeout_s = benchmark_timeout_s
        self.invocation_timeout_s = invocation_timeout_s

    def begin_run(self, parallelism: int) -> None:
        pass

    def execute(self, inv: Invocation) -> List[DuetPair]:
        duet = self.duets[inv.benchmark]
        pairs: List[DuetPair] = []
        deadline = time.monotonic() + min(self.invocation_timeout_s,
                                          inv.timeout_s * inv.repeats * 4)
        for r, order in enumerate(inv.version_order):
            v1s, v2s = duet.run_pair(order)
            if max(v1s, v2s) > self.benchmark_timeout_s:
                raise TimeoutError(
                    f"{inv.benchmark} exceeded {self.benchmark_timeout_s}s")
            pairs.append(DuetPair(benchmark=inv.benchmark, v1_seconds=v1s,
                                  v2_seconds=v2s, call_index=inv.call_index,
                                  cold_start=(r == 0)))
            if time.monotonic() > deadline:
                break
        return pairs

    def finalize(self, billed_seconds: List[float],
                 wall_seconds: float) -> float:
        return 0.0
