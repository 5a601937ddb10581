"""Deadline/cost planner: pick the execution configuration for a job.

Given a suite of workloads, a virtual-time deadline, and a billing
budget, the planner enumerates candidate configurations

    provider profile x memory policy x fleet size x repeat plan

and predicts each candidate's makespan and cost *without executing it*:

  * FaaS candidates are priced through the per-benchmark memory curves
    measured by the SeBS-style autotuner (core/autotune.py): one probe
    pass per provider fits t(mem) = cpu_bound/cpu_share(mem) + fixed per
    benchmark, and the profile's billing model does the rest.  Memory
    policies are the uniform candidate sizes plus the autotuned
    per-benchmark map (the knee of every curve).
  * VM candidates are probed directly on the VM platform model (a few
    sequential invocations), matching the paper's original-dataset
    baseline: n_vms machines, wall-clock-hour pricing.

Selection semantics (monotone by construction, property-tested):

    deadline only          cheapest candidate with makespan <= deadline
    budget only            fastest candidate with cost <= budget
    deadline + budget      cheapest candidate meeting both
    neither                cheapest candidate overall

Relaxing the deadline can only grow the feasible set, so the chosen cost
never increases; raising the budget likewise never increases the chosen
makespan.  An empty feasible set raises `InfeasiblePlanError` — the CLI
maps it to a non-zero exit code (infeasibility used to be silent).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.autotune import SuiteMemoryPlan, autotune_suite_memory
from repro_torch.core.rmit import Invocation
from repro_torch.faas.backends import PROVIDER_PROFILES, VMBackend

VM_PROVIDER = "vm"
MEMORY_AUTOTUNED = 0            # sentinel memory_mb for the autotuned policy


class InfeasiblePlanError(Exception):
    """No candidate configuration meets the deadline/budget."""

    def __init__(self, deadline_s: Optional[float],
                 budget_usd: Optional[float], n_candidates: int):
        msg = ["no feasible plan"]
        if deadline_s is not None:
            msg.append(f"deadline {deadline_s:.0f}s")
        if budget_usd is not None:
            msg.append(f"budget ${budget_usd:.2f}")
        super().__init__(" ".join(msg) + f" ({n_candidates} candidates)")
        self.deadline_s = deadline_s
        self.budget_usd = budget_usd


@dataclass(frozen=True)
class CandidatePlan:
    """One enumerated configuration with its predicted outcome."""
    provider: str                       # "lambda" | "gcf" | "azure" | "vm"
    memory_mb: int                      # MEMORY_AUTOTUNED for the tuned map
    parallelism: int                    # fleet width (n_vms for "vm")
    n_calls: int
    repeats_per_call: int
    predicted_wall_s: float
    predicted_cost_usd: float
    predicted_invocations: int
    memory_map: Optional[Tuple[Tuple[str, int], ...]] = None

    @property
    def memory_policy(self) -> str:
        if self.memory_map is not None:
            return "autotuned"
        return f"{self.memory_mb}MB" if self.memory_mb else "vm"

    @property
    def label(self) -> str:
        return (f"{self.provider}/{self.memory_policy}"
                f"/P{self.parallelism}/{self.n_calls}x{self.repeats_per_call}")

    def memory_map_dict(self) -> Optional[Dict[str, int]]:
        return None if self.memory_map is None else dict(self.memory_map)


@dataclass
class PlannerConfig:
    providers: Sequence[str] = ("lambda", "gcf", "azure")
    memory_mb: Sequence[int] = (1024, 1536, 1792, 2048, 3008)
    parallelism: Sequence[int] = (25, 50, 150, 300)
    repeat_plans: Sequence[Tuple[int, int]] = ((15, 3), (45, 1))
    autotune: bool = True               # add the per-benchmark tuned policy
    probe_mb: Sequence[int] = (1024, 1536, 2048)
    include_vm: bool = True
    vm_fleets: Sequence[int] = (1, 3, 8)
    image_gb: float = 1.0
    # a candidate must keep every probe-feasible benchmark under the
    # timeout with this margin — configurations that silently drop
    # benchmarks (paper §6.2.4's 1024 MB run) are not offered as plans
    timeout_margin: float = 0.75
    vm_probe_calls: int = 2


class DeadlineCostPlanner:
    """Enumerates + predicts + selects candidate plans for one suite.

    With a `chaos` profile (faas/chaos.py `ChaosConfig`) the planner
    prices *retry-inflated* plans: every FaaS candidate's invocation
    count, billed seconds, and cost are scaled by the scenario's expected
    attempts per invocation (losses / zombies / timeout storms at the
    configured `max_retries`), durations by the mean regime slowdown,
    storm timeouts by their expected full-timeout burns, and bills by
    the metering-anomaly inflation.  A candidate that met a deadline on
    a calm platform may be rejected (or priced over budget) under chaos
    — which is the point.  The VM baseline is not chaos-priced (the
    fault models are FaaS-platform phenomena)."""

    def __init__(self, cfg: Optional[PlannerConfig] = None, *,
                 chaos=None, max_retries: int = 0):
        self.cfg = cfg or PlannerConfig()
        self.chaos_model = (None if chaos is None or not chaos.active
                            else chaos.cost_model(max_retries=max_retries))
        self._curves: Dict[tuple, SuiteMemoryPlan] = {}
        self._vm_probe: Dict[tuple, Dict[str, float]] = {}

    # ---------------------------------------------------------- measuring
    @staticmethod
    def _suite_key(workloads: Dict) -> tuple:
        """Content key for the probe caches: SimWorkloads are frozen
        dataclasses, so the sorted item tuple is hashable and two equal
        suites share one probe pass.  (Never key by `id()` — a freed
        dict's address can be reused by a different suite.)"""
        return tuple(sorted(workloads.items()))

    def suite_curves(self, workloads: Dict, provider: str, *,
                     seed: int = 0) -> SuiteMemoryPlan:
        """Probe-and-fit memory curves for every benchmark (cached per
        (suite content, provider, seed) — one probe pass prices every
        candidate, and repeated plans over equal suites reuse it)."""
        key = (self._suite_key(workloads), provider, seed)
        if key not in self._curves:
            profile = PROVIDER_PROFILES[provider]
            self._curves[key] = autotune_suite_memory(
                workloads, profile, probe_mb=tuple(self.cfg.probe_mb),
                seed=seed)
        return self._curves[key]

    def vm_invocation_seconds(self, workloads: Dict, *, repeats: int,
                              seed: int = 0) -> Dict[str, float]:
        """Measured mean sequential-invocation seconds per benchmark on
        the VM platform model (incl. the per-trial overhead)."""
        key = (self._suite_key(workloads), repeats, seed)
        if key not in self._vm_probe:
            out: Dict[str, float] = {}
            order = tuple(("v1", "v2") for _ in range(repeats))
            for name in sorted(workloads):
                be = VMBackend({name: workloads[name]}, seed=seed)
                be.begin_run(1)
                durs = []
                for c in range(self.cfg.vm_probe_calls):
                    inv = Invocation(benchmark=name, call_index=c,
                                     repeats=repeats, version_order=order)
                    inst, _ = be.spawn_instance(inv, 0.0, 0)
                    durs.append(be.simulate(inv, inst, 0.0, 0.0).duration_s)
                out[name] = sum(durs) / len(durs)
            self._vm_probe[key] = out
        return self._vm_probe[key]

    # ---------------------------------------------------------- predicting
    def _predict_faas(self, workloads: Dict, provider: str,
                      memory_mb: int, parallelism: int, n_calls: int,
                      repeats: int, seed: int) -> Optional[CandidatePlan]:
        """Analytic prediction of one FaaS candidate from measured curves;
        None when the configuration would drop a benchmark (timeout)."""
        cfg = self.cfg
        profile = PROVIDER_PROFILES[provider]
        plan = self.suite_curves(workloads, provider, seed=seed)
        tuned = memory_mb == MEMORY_AUTOTUNED
        mem_map = plan.memory_map if tuned else None

        # chaos pricing: mean regime slowdown on every duration, expected
        # attempts per planned invocation (retries of losses / zombies /
        # storm timeouts), per-failed-attempt timeout burns, and the
        # metering-anomaly inflation on the final bill
        cm = self.chaos_model
        slow = cm.slowdown if cm is not None else 1.0
        attempts = cm.expected_attempts if cm is not None else 1.0
        fail_bill_s = 0.0
        if cm is not None and cm.retryable_rate > 0.0:
            fail_bill_s = (cm.timeout_burn_rate / cm.retryable_rate
                           * profile.benchmark_timeout_s)

        total_billed = 0.0
        total_cost = 0.0
        max_inv_s = 0.0
        n_inv = 0
        mem_sum = 0.0
        for name, curve in sorted(plan.curves.items()):
            mem = mem_map[name] if tuned else memory_mb
            if (curve.predict_run_s(profile, mem) * slow
                    >= cfg.timeout_margin * profile.benchmark_timeout_s):
                return None             # would lose this benchmark
            inv_s = curve.predict_invocation_s(profile, mem, repeats) * slow
            per_call = inv_s + (attempts - 1.0) * fail_bill_s
            total_billed += n_calls * per_call
            total_cost += n_calls * (
                profile.billed_cost([inv_s], mem)
                + (attempts - 1.0) * profile.billed_cost([fail_bill_s],
                                                         mem))
            max_inv_s = max(max_inv_s, inv_s)
            n_inv += n_calls
            mem_sum += mem
        if n_inv == 0:
            return None
        mean_mem = mem_sum / len(plan.curves)
        # benchmarks the probe pass could not fit still get dispatched by
        # the executed plan and billed: a restricted-FS benchmark fails in
        # ~0.1 s, one beyond the per-benchmark timeout burns the full
        # timeout every call — both priced in, neither invalidates the
        # candidate (they fail identically in every configuration)
        for name in plan.skipped:
            wl = workloads[name]
            fail_s = 0.1 if getattr(wl, "fs_write", False) \
                else profile.benchmark_timeout_s
            total_billed += n_calls * fail_s
            total_cost += n_calls * profile.billed_cost([fail_s], mean_mem)
            n_inv += n_calls
        # every fleet slot cold-starts once (long keep-alives keep warm
        # instances alive for the rest of the run); the setup cost is the
        # per-instance build-cache hit
        n_cold = min(parallelism, n_inv)
        setup_mean = sum(workloads[n].setup_seconds
                         for n in plan.curves) / len(plan.curves)
        cold_s = profile.cold_overhead_s(cfg.image_gb) + setup_mean
        total_billed += n_cold * cold_s
        total_cost += n_cold * profile.billed_cost([cold_s], mean_mem)
        if cm is not None:
            total_cost *= cm.billing_inflation
            n_inv = int(round(n_inv * attempts))
        # makespan: perfectly elastic work sharing + the straggler tail
        wall = (total_billed / min(parallelism, n_inv)) + max_inv_s + cold_s
        return CandidatePlan(
            provider=provider, memory_mb=memory_mb, parallelism=parallelism,
            n_calls=n_calls, repeats_per_call=repeats,
            predicted_wall_s=wall, predicted_cost_usd=total_cost,
            predicted_invocations=n_inv,
            memory_map=tuple(sorted(mem_map.items())) if tuned else None)

    def _predict_vm(self, workloads: Dict, n_vms: int, n_calls: int,
                    repeats: int, seed: int) -> CandidatePlan:
        from repro_torch.faas.platform import VMPlatformConfig
        inv_s = self.vm_invocation_seconds(workloads, repeats=repeats,
                                           seed=seed)
        total = sum(n_calls * s for s in inv_s.values())
        n_inv = n_calls * len(inv_s)
        wall = total / n_vms + max(inv_s.values(), default=0.0)
        cost = wall / 3600.0 * VMPlatformConfig().per_hour * n_vms
        return CandidatePlan(
            provider=VM_PROVIDER, memory_mb=0, parallelism=n_vms,
            n_calls=n_calls, repeats_per_call=repeats,
            predicted_wall_s=wall, predicted_cost_usd=cost,
            predicted_invocations=n_inv)

    # ---------------------------------------------------------- enumerate
    def candidates(self, workloads: Dict, *, seed: int = 0,
                   providers: Optional[Sequence[str]] = None
                   ) -> List[CandidatePlan]:
        cfg = self.cfg
        provs = list(providers if providers is not None else cfg.providers)
        mems = list(cfg.memory_mb)
        if cfg.autotune:
            mems.append(MEMORY_AUTOTUNED)
        out: List[CandidatePlan] = []
        for provider in provs:
            if provider == VM_PROVIDER:
                continue
            for mem in mems:
                for par in cfg.parallelism:
                    for n_calls, repeats in cfg.repeat_plans:
                        cand = self._predict_faas(workloads, provider, mem,
                                                  par, n_calls, repeats,
                                                  seed)
                        if cand is not None:
                            out.append(cand)
        if cfg.include_vm and (providers is None or VM_PROVIDER in provs):
            for n_vms in cfg.vm_fleets:
                for n_calls, repeats in cfg.repeat_plans:
                    out.append(self._predict_vm(workloads, n_vms, n_calls,
                                                repeats, seed))
        return out

    # ------------------------------------------------------------- choose
    @staticmethod
    def choose(candidates: Sequence[CandidatePlan], *,
               deadline_s: Optional[float] = None,
               budget_usd: Optional[float] = None) -> CandidatePlan:
        """Monotone selection (see module docstring); deterministic
        tie-break by (secondary objective, label)."""
        feasible = [c for c in candidates
                    if (deadline_s is None
                        or c.predicted_wall_s <= deadline_s)
                    and (budget_usd is None
                         or c.predicted_cost_usd <= budget_usd)]
        if not feasible:
            raise InfeasiblePlanError(deadline_s, budget_usd,
                                      len(candidates))
        if budget_usd is not None and deadline_s is None:
            # fastest within budget
            return min(feasible, key=lambda c: (c.predicted_wall_s,
                                                c.predicted_cost_usd,
                                                c.label))
        # cheapest (meeting the deadline, if any)
        return min(feasible, key=lambda c: (c.predicted_cost_usd,
                                            c.predicted_wall_s, c.label))

    def plan(self, workloads: Dict, *, deadline_s: Optional[float] = None,
             budget_usd: Optional[float] = None, seed: int = 0,
             providers: Optional[Sequence[str]] = None) -> CandidatePlan:
        cands = self.candidates(workloads, seed=seed, providers=providers)
        from repro_torch.obs import get_obs
        obs = get_obs()
        on = obs is not None and obs.enabled
        try:
            chosen = self.choose(cands, deadline_s=deadline_s,
                                 budget_usd=budget_usd)
        except InfeasiblePlanError as exc:
            if on:
                ctx = {"deadline_s": deadline_s, "budget_usd": budget_usd,
                       "n_candidates": len(cands)}
                obs.tracer.instant("plan_infeasible", cat="planner",
                                   ts=0.0, pid="planner", tid="decisions",
                                   args=ctx)
                obs.metrics.inc("planner.infeasible")
                if obs.recorder is not None:
                    obs.recorder.dump("infeasible_plan", ts=0.0,
                                      context=ctx)
            raise exc
        if on:
            obs.tracer.instant(
                "plan", cat="planner", ts=0.0, pid="planner",
                tid="decisions",
                args={"chosen": chosen.label,
                      "predicted_wall_s": chosen.predicted_wall_s,
                      "predicted_cost_usd": chosen.predicted_cost_usd,
                      "deadline_s": deadline_s, "budget_usd": budget_usd,
                      "n_candidates": len(cands)})
            obs.metrics.inc("planner.plans", provider=chosen.provider)
        return chosen

    # -------------------------------------------------------------- replan
    def replan(self, workloads: Dict, *,
               completed: Sequence[str] = (),
               spent_usd: float = 0.0, elapsed_s: float = 0.0,
               deadline_s: Optional[float] = None,
               budget_usd: Optional[float] = None, seed: int = 0,
               providers: Optional[Sequence[str]] = None,
               slowdown: Optional[Mapping[str, float]] = None
               ) -> CandidatePlan:
        """Incremental re-plan from partial progress.

        Plans only the *remaining* suite (``workloads`` minus
        ``completed``) against the *remaining* deadline and budget:
        already-billed cost (``spent_usd``) and elapsed virtual time
        (``elapsed_s``) are sunk — they shrink the constraints but are
        not re-optimized.  ``slowdown`` is a per-provider recalibration
        factor from *measured* behavior (e.g. windowed latency rings
        during an incident): candidate makespans and costs for provider
        P are scaled by ``slowdown[P]`` before selection — a first-order
        correction that keeps the curve caches valid while pricing in
        live drift.

        Monotonicity carries over from `choose`: scaling is per-provider
        and constant across a provider's candidates, so a larger
        remaining deadline still never selects a more expensive plan.
        Raises `InfeasiblePlanError` when the remaining constraints admit
        no candidate, and `ValueError` when nothing remains to plan."""
        remaining = {n: w for n, w in workloads.items()
                     if n not in set(completed)}
        if not remaining:
            raise ValueError("replan with no remaining workloads")
        rem_deadline = (None if deadline_s is None
                        else max(0.0, deadline_s - elapsed_s))
        rem_budget = (None if budget_usd is None
                      else max(0.0, budget_usd - spent_usd))
        cands = self.candidates(remaining, seed=seed, providers=providers)
        if slowdown:
            cands = [replace(c,
                             predicted_wall_s=(c.predicted_wall_s
                                               * slowdown.get(c.provider,
                                                              1.0)),
                             predicted_cost_usd=(c.predicted_cost_usd
                                                 * slowdown.get(c.provider,
                                                                1.0)))
                     for c in cands]
        chosen = self.choose(cands, deadline_s=rem_deadline,
                             budget_usd=rem_budget)
        from repro_torch.obs import get_obs
        obs = get_obs()
        if obs is not None and obs.enabled:
            obs.tracer.instant(
                "replan", cat="planner", ts=elapsed_s, pid="planner",
                tid="decisions",
                args={"chosen": chosen.label,
                      "remaining_benchmarks": len(remaining),
                      "sunk_usd": spent_usd, "elapsed_s": elapsed_s,
                      "deadline_s": rem_deadline, "budget_usd": rem_budget,
                      "slowdown": dict(slowdown or {}),
                      "n_candidates": len(cands)})
            obs.metrics.inc("planner.replans", provider=chosen.provider)
        return chosen


def pareto_frontier(candidates: Sequence[CandidatePlan]
                    ) -> List[CandidatePlan]:
    """Non-dominated (cost, makespan) candidates, cheapest first."""
    ranked = sorted(candidates, key=lambda c: (c.predicted_cost_usd,
                                               c.predicted_wall_s, c.label))
    out: List[CandidatePlan] = []
    best_wall = float("inf")
    for c in ranked:
        if c.predicted_wall_s < best_wall:
            out.append(c)
            best_wall = c.predicted_wall_s
    return out
