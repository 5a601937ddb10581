"""The port's benchmarking service (``repro_torch.service``: fair queue,
deadline/cost planner, scheduler, re-planning) against the JAX package's,
on the cases of tests/test_service_{queue,planner,scheduler,replan,vec}.py
and the command-line collisions of tests/test_exit_codes.py.

The service runs in virtual time on the same NumPy code on both sides, so
schedules, digests, plans, controller events, summary lines and exit codes
must agree bit for bit.  The 16-tenant golden digest replays in the port
under each observability mode of the port's context, on both engines.
"""
import importlib
import json

import numpy as np
import pytest

from test_torch_obs import obs_mode, restore_contexts  # noqa: F401 (fixtures)

SIDES = ("repro", "repro_torch")
GOLDEN_16_TENANT_DIGEST = "65e8852bf2dce3a7"      # tests/test_service_scheduler.py:19


class _Mods:
    def __init__(self, pkg):
        self.obs = importlib.import_module(f"{pkg}.obs")
        self.service = importlib.import_module(f"{pkg}.service")
        for name in ("service.queue", "service.planner", "core.experiment", "faas.chaos",
                     "faas.engine_vec", "faas.platform", "cb.cli"):
            setattr(self, name.split(".")[-1], importlib.import_module(f"{pkg}.{name}"))


MODS = {pkg: _Mods(pkg) for pkg in SIDES}
PORT = MODS["repro_torch"]


def canon(obj):
    return json.dumps(obj, sort_keys=True, default=repr)


def both(fn):
    """``fn(mods)`` on each side; asserts the results are equal as JSON and
    returns the port's."""
    got, ref = fn(PORT), fn(MODS["repro"])
    assert canon(got) == canon(ref)
    return got


def _suite(m, n=10):
    full = m.experiment.victoriametrics_like_suite()
    return {k: v for k, v in sorted(full.items())[:2 * n]
            if not v.fs_write and v.base_seconds < 10.0}


def _job(m, jid, tenant, workloads, **kw):
    kw.setdefault("n_calls", 5)
    kw.setdefault("repeats_per_call", 2)
    kw.setdefault("seed", sum(ord(c) for c in jid) % 1000)
    return m.service.Job(job_id=jid, tenant=tenant, workloads=workloads, **kw)


# ------------------------------------------------------------ scheduler
@pytest.mark.parametrize("engine", ["fast", "reference"])
def test_sixteen_concurrent_streams_golden_digest(obs_mode, engine):  # noqa: F811
    """48 commit-stream jobs of 16 tenants on one lambda fleet replay the
    pinned schedule digest, and a recording context's counters agree with
    the service's own accounting."""
    r = PORT.experiment.run_multi_tenant_experiment(16, provider="lambda", seed=34,
                                                    engine=engine)
    assert r.jobs >= 16 and r.fairness > 0.9
    assert r.digest == GOLDEN_16_TENANT_DIGEST
    if obs_mode.enabled:
        mx = obs_mode.metrics
        assert mx.counter_total("service.invocations") == r.total_invocations
        assert mx.counter_total("engine.invocations") == r.total_invocations
        assert mx.counter_total("engine.cold_starts") == r.cold_starts
        assert mx.counter_total("service.cost_usd") == r.total_cost_usd
        assert len(mx.label_values("tenant")) == 16


def test_scheduler_cases_match_jax():
    """Preemption, causal delivery, fair share and per-benchmark memory, as
    tests/test_service_scheduler.py runs them: every result equals JAX's."""
    def probe(m):
        wl = _suite(m, 8)
        svc = m.service.BenchmarkService(m.service.ServiceConfig(parallelism=10))
        svc.submit(_job(m, "rich", "a", wl, seed=1), provider="lambda")
        svc.submit(_job(m, "poor", "b", wl, seed=2, budget_usd=0.0005), provider="lambda")
        svc.submit(_job(m, "tuned", "c", wl, seed=5), provider="gcf", memory_mb=2048,
                   memory_map={b: 1792 for b in wl})
        for t in range(3):
            svc.submit(_job(m, f"job{t}", f"tenant{t}", wl, seed=60 + t), provider="lambda")
        rep = svc.run()
        return (rep.digest(), rep.preempted_jobs, [r.job_id for r in rep.results],
                rep.fairness, rep.tenant_billed_s, rep.latencies_s(),
                [(r.status, r.invocations, r.skipped_invocations, r.cost_dollars)
                 for r in rep.results])
    _, preempted, _, _, _, _, results = both(probe)
    assert preempted == ["poor"] and any(s == "preempted" for s, *_ in results)


def test_admission_rejects_as_jax_does():
    def probe(m):
        wl = _suite(m, 4)
        svc = m.service.BenchmarkService(m.service.ServiceConfig(
            admission=m.service.AdmissionConfig(max_queued_jobs=2, max_jobs_per_tenant=1)))
        svc.submit(_job(m, "a1", "loud", wl), provider="lambda")
        for jid, tenant in (("a2", "loud"), ("b1", "quiet"), ("c1", "late")):
            try:
                svc.submit(_job(m, jid, tenant, wl), provider="lambda")
            except m.service.AdmissionError:
                pass
        return svc.rejected, [r.job_id for r in svc.run().results]
    rejected, ran = both(probe)
    assert [j for j, _ in rejected] == ["a2", "c1"] and sorted(ran) == ["a1", "b1"]


# ---------------------------------------------------------------- queue
@pytest.mark.parametrize("weights", [None, {"heavy": 3.0, "light": 1.0}, {"x": 2.0}])
def test_fair_queue_order_matches_jax(weights):
    rng = np.random.default_rng(len(weights or ()))
    pushes = [(("heavy", "light", "x", "y")[int(rng.integers(4))], i,
               float(rng.uniform(0.5, 4.0)), float(rng.choice([1.0, 1.0, 4.0])))
              for i in range(120)]

    def probe(m):
        q = m.queue.FairQueue(weights=weights)
        out = []
        for n, (tenant, item, size, scale) in enumerate(pushes):
            q.push(tenant, item, size=size, weight_scale=scale)
            if n % 3 == 2:
                out.append(q.pop())
        return out + list(q.drain())
    order = both(probe)
    assert sorted(item for _, item in order) == list(range(120))


# -------------------------------------------------------------- planner
def _planner_cfg(m):
    return m.planner.PlannerConfig(providers=("lambda", "azure"), memory_mb=(1024, 2048),
                                   parallelism=(10, 40), repeat_plans=((6, 2), (12, 1)),
                                   vm_fleets=(1, 3))


def _small_suite(m, n=8):
    return {f"b{i}": m.platform.SimWorkload(name=f"b{i}", base_seconds=0.4 + 0.3 * i,
                                            effect_pct=4.0 * (i % 2), setup_seconds=3.0)
            for i in range(n)}


@pytest.fixture(scope="module")
def candidates():
    return {pkg: m.planner.DeadlineCostPlanner(_planner_cfg(m)).candidates(
        _small_suite(m), seed=3) for pkg, m in MODS.items()}


def test_planner_candidates_and_frontier_match_jax(candidates):
    got, ref = candidates["repro_torch"], candidates["repro"]
    assert canon(got) == canon(ref)
    assert canon(PORT.planner.pareto_frontier(got)) == \
        canon(MODS["repro"].planner.pareto_frontier(ref))
    assert {c.provider for c in got} == {"lambda", "azure", "vm"}


def test_planner_selection_is_monotone_and_matches_jax(candidates):
    """Relaxing the deadline never raises the chosen cost; raising the
    budget never lengthens the chosen makespan; every choice (or refusal)
    equals JAX's."""
    rng = np.random.default_rng(0)
    cands = candidates["repro_torch"]
    choose = {pkg: MODS[pkg].planner.DeadlineCostPlanner.choose for pkg in SIDES}

    def pick(pkg, **kw):
        try:
            return choose[pkg](candidates[pkg], **kw)
        except MODS[pkg].planner.InfeasiblePlanError:
            return None
    for _ in range(60):
        d1, slack = float(rng.uniform(1.0, 50_000.0)), float(rng.uniform(0.0, 10_000.0))
        b1, extra = float(rng.uniform(1e-4, 100.0)), float(rng.uniform(0.0, 100.0))
        got = [pick("repro_torch", deadline_s=d) for d in (d1, d1 + slack)] + \
            [pick("repro_torch", budget_usd=b) for b in (b1, b1 + extra)]
        ref = [pick("repro", deadline_s=d) for d in (d1, d1 + slack)] + \
            [pick("repro", budget_usd=b) for b in (b1, b1 + extra)]
        assert canon(got) == canon(ref)
        if got[0] is not None:
            assert got[1].predicted_cost_usd <= got[0].predicted_cost_usd
        if got[2] is not None:
            assert got[3].predicted_wall_s <= got[2].predicted_wall_s
    assert choose["repro_torch"](cands).predicted_cost_usd == min(
        c.predicted_cost_usd for c in cands)
    with pytest.raises(PORT.planner.InfeasiblePlanError):
        choose["repro_torch"](cands, deadline_s=0.001)


# --------------------------------------------------------------- replan
def _replan_planner(m):
    return m.planner.DeadlineCostPlanner(m.planner.PlannerConfig(
        providers=("lambda", "gcf"), memory_mb=(2048,), parallelism=(8, 16),
        repeat_plans=((5, 2),), autotune=False, include_vm=False))


def _storm(m):
    return m.chaos.ChaosConfig(intensity=1.0, seed=0, faults=(
        m.chaos.FaultSpec(m.chaos.TIMEOUT_STORM, rate=0.9, period_s=10_000_000.0,
                          window_s=2000.0, phase_s=0.0),))


def _managed(m, jid, tenant, wl, **kw):
    kw.setdefault("deadline_s", 4000.0)
    kw.setdefault("budget_usd", 2.0)
    return _job(m, jid, tenant, wl, **kw)


def test_replanning_under_a_timeout_storm_matches_jax():
    """A canary runs through a lambda timeout storm and opens triggers; the
    next managed job is steered to gcf, and a budget-preempted job resumes
    on a healthy provider: the controller's events and both rounds'
    schedules equal JAX's."""
    def probe(m):
        wl = _suite(m, 6)
        with m.obs.use_obs(m.obs.Observability.monitoring()) as obs:
            svc = m.service.BenchmarkService(
                m.service.ServiceConfig(parallelism=8, seed=11, chaos={"lambda": _storm(m)}),
                planner=_replan_planner(m))
            ctrl = svc.attach_controller(m.service.ReplanController(m.service.ReplanConfig()))
            svc.submit(m.service.Job(job_id="canary-0", tenant="canary", workloads=wl,
                                     n_calls=25, repeats_per_call=2, seed=100,
                                     metadata={"pin": True}), provider="lambda")
            svc.submit(_managed(m, "tight", "t0", wl, seed=7, budget_usd=0.016))
            first = svc.run()
            svc.submit(_managed(m, "m1", "t1", wl, seed=31))
            second = svc.run()
            feed, _ = obs.monitor.alert_feed()
        return (first.digest(), second.digest(), first.preempted_jobs,
                {r.job_id: r.provider for r in second.results}, ctrl.events,
                ctrl.sick_providers(), ctrl.summary(), len(feed))
    _, _, preempted, providers, events, sick, _, _ = both(probe)
    assert "tight" in preempted and "lambda" in sick
    assert providers["m1"] == "gcf" and providers["tight~r"] not in sick
    kinds = {e["event"] for e in events}
    assert {"trigger_open", "migrate", "resume"} <= kinds


@pytest.mark.parametrize("engine", ["fast", "reference"])
def test_zero_trigger_identity(engine):
    """Armed but never firing (no chaos), the controller changes no
    schedule, and the digests equal JAX's."""
    def probe(m):
        wl = _suite(m, 4)
        digests = []
        for armed in (False, True):
            with m.obs.use_obs(m.obs.Observability.monitoring()):
                svc = m.service.BenchmarkService(
                    m.service.ServiceConfig(parallelism=8, seed=11, engine=engine),
                    planner=_replan_planner(m))
                ctrl = svc.attach_controller(
                    m.service.ReplanController(m.service.ReplanConfig())) if armed else None
                for rnd in range(2):
                    svc.submit(m.service.Job(job_id=f"canary-{rnd}", tenant="canary",
                                             workloads=wl, n_calls=8, repeats_per_call=2,
                                             seed=100 + rnd, metadata={"pin": True}),
                               provider="lambda")
                    for j in range(2):
                        svc.submit(_managed(m, f"job-{rnd}{j}", f"t{j}", wl,
                                            seed=200 + rnd * 10 + j))
                    digests.append(svc.run().digest())
        assert ctrl.events == [] and ctrl.held == []
        return digests
    digests = both(probe)
    assert digests[:2] == digests[2:]


# ------------------------------------------------------ vectorised path
@pytest.mark.parametrize("chaos_on", [False, True], ids=["chaos_off", "chaos_moderate"])
@pytest.mark.parametrize("n_tenants", [8, 16])
def test_vec_digests_equal_the_scalar_loop(n_tenants, chaos_on):
    def probe(m):
        out = []
        for engine in ("fast", "reference"):
            m.engine_vec.reset_fallback_log()
            r = m.experiment.run_multi_tenant_experiment(
                n_tenants, provider="lambda", n_commits=2, n_calls=5, repeats_per_call=2,
                seed=91, chaos=m.chaos.moderate_chaos(seed=5) if chaos_on else None,
                engine=engine)
            out.append((r.digest, r.total_invocations, r.total_cost_usd,
                        sorted(set(m.engine_vec.get_fallback_log()))))
        return out
    (fast, *_, fb), (ref, *_, _) = both(probe)
    assert fast == ref and (chaos_on or not fb)


@pytest.mark.parametrize("quantum", [1, 64])
def test_budget_preemption_vec_equals_reference(quantum):
    def probe(m):
        out = []
        for engine in ("fast", "reference"):
            wl = _suite(m, 8)
            svc = m.service.BenchmarkService(m.service.ServiceConfig(
                parallelism=10, engine=engine, schedule_quantum=quantum))
            svc.submit(_job(m, "rich", "a", wl, seed=1), provider="lambda")
            svc.submit(_job(m, "poor", "b", wl, seed=2, budget_usd=0.0005), provider="lambda")
            svc.submit(_job(m, "mid", "c", wl, seed=3, budget_usd=0.02), provider="lambda")
            rep = svc.run()
            out.append((rep.digest(), rep.preempted_jobs))
        return out
    fast, ref = both(probe)
    assert fast == ref and fast[1] == ["poor"]


# ------------------------------------------- command-line exit collisions
_FAST_SERVICE = ["--commits", "3", "--n-calls", "6", "--mode", "selective", "--seed", "3",
                 "--jobs", "2", "--engine", "fast"]


def _force_fallback(mp, m):
    mp.setattr(m.engine_vec, "get_fallback_log", lambda: ["injected: test fallback"])


def _force_breach(mp, m):
    real = m.obs.Observability.health

    def breached(self):
        h = real(self)
        h["verdict"] = "breach"
        return h
    mp.setattr(m.obs.Observability, "health", breached)


def _infeasible_on(mp, m, provider):
    real = m.planner.DeadlineCostPlanner.plan

    def plan(self, workloads, **kw):
        if tuple(kw.get("providers") or ()) == (provider,):
            raise m.planner.InfeasiblePlanError(kw.get("deadline_s"), kw.get("budget_usd"), 0)
        return real(self, workloads, **kw)
    mp.setattr(m.planner.DeadlineCostPlanner, "plan", plan)


@pytest.mark.parametrize("case, flags, want", [
    ("infeasible+fallback", ["--providers", "lambda,azure", "--deadline", "1800"], 2),
    ("infeasible+breach", ["--providers", "lambda", "--deadline", "0.5", "--slo"], 2),
    ("fallback+breach", ["--providers", "lambda", "--slo"], 3),
    ("breach", ["--providers", "lambda", "--slo"], 4),
], ids=lambda v: v if isinstance(v, str) else None)
def test_cli_exit_code_collisions_match_jax(case, flags, want, monkeypatch, capsys,
                                            restore_contexts):  # noqa: F811
    """tests/test_exit_codes.py's four collisions, each forced on both sides
    through the same seams: the exit code, the summary lines and the
    messages equal JAX's."""
    def probe(m):
        with monkeypatch.context() as mp:
            if "fallback" in case:
                _force_fallback(mp, m)
            if "breach" in case:
                _force_breach(mp, m)
            if case == "infeasible+fallback":
                _infeasible_on(mp, m, "azure")
            code = m.cli.main(_FAST_SERVICE + flags)
        m.obs.set_obs(None)
        cap = capsys.readouterr()
        return code, cap.out.splitlines(), cap.err.splitlines()
    code, out, err = both(probe)
    assert code == want
    if "breach" in case:
        assert any("slo verdict: breach" in line for line in err)
    if case != "infeasible+breach":
        assert json.loads(out[0])["provider"] == "lambda"
