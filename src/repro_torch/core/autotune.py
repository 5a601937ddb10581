"""Beyond-paper: per-benchmark function-memory autotuning (paper §7.1).

The paper runs every microbenchmark at 2048 MB "to ensure no microbenchmark
runs out of memory" and names per-benchmark right-sizing as future work,
cautioning that CPU-coupled memory scaling can distort results.  This module
implements that future work against the platform model:

  * find, per benchmark, the cheapest memory size whose (a) runs stay under
    the 20 s timeout with margin and (b) detected relative change stays
    consistent with the 2048 MB reference (duet relativity makes the result
    largely memory-invariant — the *detection*, not the absolute time);
  * produce a per-benchmark memory map and its cost.

Two tuners live here:

  * `autotune_memory` — the original analytic right-sizer: predicts run
    times from the workload's known ground truth (simulation-only).
  * `probe_memory_curve` / `autotune_suite_memory` — the SeBS-style
    *measured* tuner (Copik et al.): invoke the benchmark at a few memory
    sizes, fit the speed curve t(mem) = cpu_bound/cpu_share(mem) + fixed,
    and pick the knee — the cheapest size that keeps runs safely under the
    per-benchmark timeout.  The fitted `MemoryCurve`s double as the
    service planner's duration/cost predictor at *any* memory size, so one
    probe pass prices every candidate configuration.

Deterministic, pure simulation — the real-fleet version would use the same
search driven by the elastic controller.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import rmit
from repro_torch.core.results import analyze
from repro_torch.core.rmit import Invocation
from repro_torch.core.stats import ChangeResult, agree
from repro_torch.faas.backends import LAMBDA_PROFILE, ProviderProfile, SimFaaSBackend
from repro_torch.faas.platform import FaaSPlatformConfig, SimWorkload, SimulatedFaaS


@dataclass
class AutotuneResult:
    memory_map: Dict[str, int]
    reference_cost: float
    tuned_cost: float
    detections_consistent: float       # fraction agreeing with reference
    skipped: Sequence[str]             # benchmarks kept at reference memory

    @property
    def savings_pct(self) -> float:
        if self.reference_cost <= 0:
            return 0.0
        return (1 - self.tuned_cost / self.reference_cost) * 100


def autotune_memory(suite: Dict[str, SimWorkload], *,
                    candidate_mb: Sequence[int] = (512, 768, 1024, 1536, 1792, 2048),
                    reference_mb: int = 2048, timeout_margin: float = 0.6,
                    n_calls: int = 15, repeats: int = 3, parallelism: int = 150,
                    seed: int = 0) -> AutotuneResult:
    plan = rmit.make_plan(sorted(suite), n_calls=n_calls,
                          repeats_per_call=repeats, seed=seed)

    def run(mem: int):
        platform = SimulatedFaaS(suite, FaaSPlatformConfig(memory_mb=mem),
                                 seed=seed)
        return platform.run_suite(plan, parallelism=parallelism)

    ref_report = run(reference_mb)
    ref_changes = analyze(ref_report.pairs, seed=seed)

    # predicted per-run time scales with 1/cpu_factor; predicted billing is
    # mem * time.  Below the 1-vCPU knee the platform's super-linear CPU
    # scaling makes small memory MORE expensive (cost ~ mem^(1-2.3)) — so the
    # optimizer picks the cheapest *feasible* point, which sits just above
    # the knee, not the smallest memory (paper §7.1's caution, quantified).
    memory_map: Dict[str, int] = {}
    skipped = []
    for name, wl in suite.items():
        if wl.fs_write:
            memory_map[name] = reference_mb
            skipped.append(name)
            continue
        worst = wl.base_seconds * (1 + abs(wl.effect_pct) / 100) * 1.3
        best, best_cost = reference_mb, float("inf")
        for mem in sorted(candidate_mb):
            cfg = FaaSPlatformConfig(memory_mb=mem)
            t = worst / cfg.cpu_factor
            if t >= timeout_margin * cfg.benchmark_timeout_s:
                continue
            cost = mem * t
            if cost < best_cost:
                best, best_cost = mem, cost
        memory_map[name] = best

    # execute the tuned configuration (per-benchmark platforms)
    tuned_cost = 0.0
    tuned_changes: Dict[str, ChangeResult] = {}
    for mem in sorted(set(memory_map.values())):
        names = [n for n, m in memory_map.items() if m == mem]
        sub = {n: suite[n] for n in names}
        sub_plan = rmit.make_plan(sorted(sub), n_calls=n_calls,
                                  repeats_per_call=repeats, seed=seed)
        rep = SimulatedFaaS(sub, FaaSPlatformConfig(memory_mb=mem),
                            seed=seed).run_suite(sub_plan,
                                                 parallelism=parallelism)
        tuned_cost += rep.cost_dollars
        tuned_changes.update(analyze(rep.pairs, seed=seed))

    common = set(ref_changes) & set(tuned_changes)
    consistent = (sum(agree(ref_changes[n], tuned_changes[n]) for n in common)
                  / max(len(common), 1))
    return AutotuneResult(memory_map=memory_map,
                          reference_cost=ref_report.cost_dollars,
                          tuned_cost=tuned_cost,
                          detections_consistent=consistent,
                          skipped=skipped)


# -------------------------------------------------- SeBS-style measured tuner
@dataclass(frozen=True)
class MemoryProbe:
    """One measured point of a benchmark's memory/speed curve."""
    memory_mb: int
    mean_run_s: float               # mean single-run duration (warm)
    cost_per_call: float            # billed cost of one warm invocation
    timed_out: bool = False


@dataclass(frozen=True)
class MemoryCurve:
    """Fitted speed model t(mem) = cpu_bound / cpu_share(mem) + fixed.

    `cpu_bound_s` is the CPU-coupled part of one run (scales with the
    provider's memory→vCPU curve), `fixed_s` the memory-invariant part.
    The curve predicts a run's duration — and from it an invocation's
    billed seconds and cost — at any memory size, which is what lets the
    planner price candidate configurations it never executed."""
    benchmark: str
    cpu_bound_s: float
    fixed_s: float
    probes: Tuple[MemoryProbe, ...] = ()

    def predict_run_s(self, profile: ProviderProfile,
                      memory_mb: float) -> float:
        return self.cpu_bound_s / profile.cpu_share(memory_mb) + self.fixed_s

    def predict_invocation_s(self, profile: ProviderProfile,
                             memory_mb: float, repeats: int) -> float:
        """Billed seconds of one warm invocation: `repeats` duet pairs,
        two runs per pair."""
        return 2 * repeats * self.predict_run_s(profile, memory_mb)

    def predict_invocation_cost(self, profile: ProviderProfile,
                                memory_mb: float, repeats: int) -> float:
        secs = self.predict_invocation_s(profile, memory_mb, repeats)
        return profile.billed_cost([secs], memory_mb)

    def knee(self, profile: ProviderProfile,
             candidate_mb: Sequence[int], *, repeats: int = 3,
             timeout_margin: float = 0.6,
             fallback_mb: int = 2048) -> int:
        """The cheapest candidate whose predicted run stays under
        `timeout_margin` of the per-benchmark timeout.  Below the 1-vCPU
        knee super-linear CPU scaling makes small memory *more* expensive,
        so the pick sits just above the knee, not at the smallest size."""
        best, best_cost = fallback_mb, float("inf")
        for mem in sorted(candidate_mb):
            if (self.predict_run_s(profile, mem)
                    >= timeout_margin * profile.benchmark_timeout_s):
                continue
            cost = self.predict_invocation_cost(profile, mem, repeats)
            if cost < best_cost:
                best, best_cost = mem, cost
        return best


def probe_memory_curve(workload: SimWorkload,
                       profile: ProviderProfile = LAMBDA_PROFILE, *,
                       probe_mb: Sequence[int] = (1024, 1536, 2048),
                       n_probe_calls: int = 3, repeats: int = 2,
                       seed: int = 0) -> Optional[MemoryCurve]:
    """Measure one benchmark at a few memory sizes and fit its curve.

    Each probe is a handful of warm invocations on the platform model
    (deterministic in the seed); a probe whose runs exceed the timeout
    yields no timings and is excluded from the fit.  Returns None when the
    benchmark cannot run at all (restricted FS) or fewer than two probe
    sizes produced timings — the caller keeps the reference memory then."""
    if workload.fs_write:
        return None
    name = workload.name
    probes: List[MemoryProbe] = []
    fit_pts: List[Tuple[float, float]] = []     # (cpu_share, mean_run_s)
    order = tuple(("v1", "v2") for _ in range(repeats))
    for mem in sorted(probe_mb):
        backend = SimFaaSBackend({name: workload}, profile, memory_mb=mem,
                                 seed=seed)
        backend.begin_run(1)
        runs: List[float] = []
        cost = 0.0
        timed_out = False
        for c in range(n_probe_calls):
            inv = Invocation(benchmark=name, call_index=c, repeats=repeats,
                             version_order=order,
                             timeout_s=profile.benchmark_timeout_s)
            inst, _ = backend.spawn_instance(inv, 0.0, 0)
            out = backend.simulate(inv, inst, 0.0, 0.0)   # warm timing
            if out.timed_out or not out.ok:
                timed_out = timed_out or out.timed_out
                continue
            for p in out.pairs:
                runs.extend((p.v1_seconds, p.v2_seconds))
            cost += profile.billed_cost([out.duration_s], mem)
        mean = float(np.mean(runs)) if runs else float("nan")
        probes.append(MemoryProbe(memory_mb=mem, mean_run_s=mean,
                                  cost_per_call=cost / max(len(runs), 1)
                                  * 2 * repeats,
                                  timed_out=timed_out))
        if runs:
            fit_pts.append((profile.cpu_share(mem), mean))
    if len(fit_pts) < 2:
        return None
    # least squares on t = a * (1/cpu_share) + b, clamped to the physical
    # region a, b >= 0 (a pure-CPU benchmark fits b ~ 0 and vice versa)
    inv_cf = np.array([1.0 / cf for cf, _ in fit_pts])
    t = np.array([s for _, s in fit_pts])
    design = np.stack([inv_cf, np.ones_like(inv_cf)], axis=1)
    (a, b), *_ = np.linalg.lstsq(design, t, rcond=None)
    if b < 0.0:
        b = 0.0
        a = float(np.mean(t / inv_cf))
    if a < 0.0:
        a = 0.0
        b = float(np.mean(t))
    return MemoryCurve(benchmark=name, cpu_bound_s=float(a),
                       fixed_s=float(b), probes=tuple(probes))


@dataclass
class SuiteMemoryPlan:
    """Measured autotuning result for a whole suite: the per-benchmark
    memory map plus the fitted curves the planner predicts with."""
    memory_map: Dict[str, int]
    curves: Dict[str, MemoryCurve]
    skipped: Sequence[str]          # kept at reference memory (no curve)
    reference_mb: int


def autotune_suite_memory(suite: Dict[str, SimWorkload],
                          profile: ProviderProfile = LAMBDA_PROFILE, *,
                          candidate_mb: Sequence[int] = (512, 768, 1024,
                                                         1536, 1792, 2048,
                                                         3008),
                          probe_mb: Sequence[int] = (1024, 1536, 2048),
                          reference_mb: int = 2048, repeats: int = 3,
                          timeout_margin: float = 0.6,
                          seed: int = 0) -> SuiteMemoryPlan:
    """Probe + fit + knee for every benchmark in the suite."""
    memory_map: Dict[str, int] = {}
    curves: Dict[str, MemoryCurve] = {}
    skipped: List[str] = []
    for name in sorted(suite):
        curve = probe_memory_curve(suite[name], profile, probe_mb=probe_mb,
                                   repeats=max(1, repeats - 1), seed=seed)
        if curve is None:
            memory_map[name] = reference_mb
            skipped.append(name)
            continue
        curves[name] = curve
        memory_map[name] = curve.knee(profile, candidate_mb, repeats=repeats,
                                      timeout_margin=timeout_margin,
                                      fallback_mb=reference_mb)
    return SuiteMemoryPlan(memory_map=memory_map, curves=curves,
                           skipped=skipped, reference_mb=reference_mb)
