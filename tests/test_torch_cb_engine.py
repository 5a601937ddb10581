"""The port's copy of the execution layer (engine, backends, platforms,
controllers) against the JAX package's.

The virtual-time loop is the same NumPy code on both sides, so its reports
must agree bit for bit, wall time and cost included.  The realtime loop
runs deterministic fake duets at parallelism 1, so their pairs and the
order they come back in must agree; its wall and billed seconds are host
clock readings and are only checked to be there.
"""
import json
import os
from dataclasses import asdict, replace

import pytest

from repro.core import controller as jax_controller
from repro.core import rmit as jax_rmit
from repro.core.duet import DuetRunnable as JaxDuetRunnable
from repro.faas import backends as jax_backends
from repro.faas import engine as jax_engine
from repro.faas import platform as jax_platform
from repro_torch.core import controller, rmit
from repro_torch.core.duet import DuetRunnable
from repro_torch.core import experiment
from repro_torch.faas import backends, engine, engine_vec, platform
from test_torch_obs import obs_mode  # noqa: F401 (fixture)

N = 14
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_seed_baseline.json")


def canon(obj):
    """Exact, class-blind text of a nest of dataclasses, dicts, lists and
    floats: two results are bit-identical iff their texts are equal."""
    if hasattr(obj, "__dataclass_fields__"):
        obj = asdict(obj)
    return json.dumps(obj, sort_keys=True, default=repr)


def _workloads(mod):
    """tests/test_cb_pipeline.py's 14 workloads (s13 writes to the
    filesystem and fails on FaaS), with effects on a few of them."""
    return {f"s{i:02d}": mod.SimWorkload(
        name=f"s{i:02d}", base_seconds=0.4 + 0.05 * i, effect_pct=(0.0, 6.0, -9.0)[i % 3],
        run_sigma=0.02 + 0.002 * (i % 5), fs_write=(i == 13), setup_seconds=2.0)
        for i in range(N)}


def _plan(mod, seed=3, n_calls=10, repeats=2):
    return mod.make_plan(sorted(_workloads(platform)), n_calls=n_calls,
                         repeats_per_call=repeats, seed=seed)


_CASES = {
    "lambda": lambda m, w: m.LambdaLikeBackend(w, seed=3),
    "gcf": lambda m, w: m.GCFLikeBackend(w, seed=4, memory_mb=1024),
    "azure": lambda m, w: m.AzureLikeBackend(w, seed=5, start_time_s=3600.0),
    "sim_gcf_profile": lambda m, w: m.SimFaaSBackend(w, m.GCF_PROFILE, seed=6),
    "vm": lambda m, w: m.VMBackend(w, seed=1),
}


@pytest.mark.parametrize("backend", sorted(_CASES))
@pytest.mark.parametrize("cfg", [
    dict(parallelism=50),
    dict(parallelism=4, max_retries=2),
    dict(parallelism=8, hedge_after_factor=1.5, hedge_min_samples=4, hedge_min_s=0.5),
])
def test_virtual_loop_reports_match_jax(backend, cfg):
    make = _CASES[backend]
    if backend == "vm":
        cfg = {**cfg, "parallelism": 3}      # one slot per VM of the fleet
    got = engine.ExecutionEngine(make(backends, _workloads(platform)),
                                 engine.EngineConfig(**cfg)).run(_plan(rmit))
    ref = jax_engine.ExecutionEngine(make(jax_backends, _workloads(jax_platform)),
                                     jax_engine.EngineConfig(**cfg)).run(_plan(jax_rmit))
    assert got.invocations_done > 0 and len(got.pairs) > 100
    assert got.wall_seconds > 0 and got.cost_dollars > 0
    assert canon(got) == canon(ref)


def test_provider_backends_by_name_match_jax():
    for provider in ("lambda", "gcf", "azure"):
        got = engine.ExecutionEngine(platform.make_provider_backend(
            _workloads(platform), provider, seed=9, start_time_s=60.0),
            engine.EngineConfig(parallelism=20)).run(_plan(rmit, seed=9))
        ref = jax_engine.ExecutionEngine(jax_platform.make_provider_backend(
            _workloads(jax_platform), provider, seed=9, start_time_s=60.0),
            jax_engine.EngineConfig(parallelism=20)).run(_plan(jax_rmit, seed=9))
        assert canon(got) == canon(ref), provider


def test_simulated_platform_wrappers_match_jax():
    """The wrappers take each package's default engine, the vectorised one,
    whose pairs come back as a lazy ``PairSeq``."""
    got = platform.SimulatedFaaS(_workloads(platform), seed=2).run_suite(
        _plan(rmit), parallelism=30)
    ref = jax_platform.SimulatedFaaS(_workloads(jax_platform), seed=2).run_suite(
        _plan(jax_rmit), parallelism=30)
    assert canon(replace(got, pairs=list(got.pairs))) == canon(replace(ref, pairs=list(ref.pairs)))
    got = platform.SimulatedVM(_workloads(platform)).run_suite(_plan(rmit, n_calls=4))
    ref = jax_platform.SimulatedVM(_workloads(jax_platform)).run_suite(
        _plan(jax_rmit, n_calls=4))
    assert got.pairs and canon(replace(got, pairs=list(got.pairs))) == canon(
        replace(ref, pairs=list(ref.pairs)))


class FakeDuets:
    """Deterministic duets: each version returns the next value of its own
    counter; ``bad`` raises, ``slow`` reports more than the timeout."""

    def __init__(self, cls):
        self.cls = cls

    def make(self):
        duets = {}
        for i, name in enumerate(("alpha", "beta", "gamma")):
            duets[name] = self.cls(name, self._counter(1e-3 * (i + 1), 1.0),
                                   self._counter(1e-3 * (i + 1), 1.0 + 0.05 * (i - 1)))
        duets["bad"] = self.cls("bad", self._raise, self._raise)
        duets["slow"] = self.cls("slow", lambda: 100.0, lambda: 100.0)
        return duets

    @staticmethod
    def _counter(base, factor):
        state = {"k": 0}

        def run():
            state["k"] += 1
            return base * factor * (1.0 + 1e-3 * state["k"])
        return run

    @staticmethod
    def _raise():
        raise RuntimeError("the version failed")


def _realtime(rmit_mod, backends_mod, engine_mod, cls, cfg):
    duets = FakeDuets(cls).make()
    plan = rmit_mod.make_plan(sorted(duets), n_calls=6, repeats_per_call=2, seed=8)
    backend = backends_mod.LocalDuetBackend(duets, benchmark_timeout_s=60.0)
    return engine_mod.ExecutionEngine(backend, engine_mod.EngineConfig(**cfg)).run(plan)


@pytest.mark.parametrize("cfg", [dict(parallelism=1), dict(parallelism=1, max_retries=2)])
def test_realtime_loop_pairs_and_order_match_jax(cfg):
    got = _realtime(rmit, backends, engine, DuetRunnable, cfg)
    ref = _realtime(jax_rmit, jax_backends, jax_engine, JaxDuetRunnable, cfg)
    assert len(got.pairs) == 3 * 6 * 2
    assert got.failed_benchmarks == ["bad", "slow"]
    assert len(got.billed_seconds) == len(ref.billed_seconds) and got.wall_seconds > 0
    assert canon(replace(got, wall_seconds=0.0, billed_seconds=[])) == \
        canon(replace(ref, wall_seconds=0.0, billed_seconds=[]))


def test_elastic_controller_matches_jax():
    def run(mod, cls, rmit_mod):
        duets = FakeDuets(cls).make()
        plan = rmit_mod.make_plan(sorted(duets), n_calls=5, repeats_per_call=1, seed=3)
        ctl = mod.ElasticController(duets, mod.ControllerConfig(
            max_parallelism=1, benchmark_timeout_s=60.0, min_results=5))
        return ctl.run_suite(plan)
    got = run(controller, DuetRunnable, rmit)
    ref = run(jax_controller, JaxDuetRunnable, jax_rmit)
    assert got.invocations_done == 15 and got.failed_benchmarks == ["bad", "slow"]
    assert canon(replace(got, wall_seconds=0.0)) == canon(replace(ref, wall_seconds=0.0))


def test_adaptive_controller_matches_jax():
    def run(ctl_mod, rmit_mod, be_mod, eng_mod, plat_mod):
        plan = rmit_mod.make_plan(sorted(_workloads(plat_mod)), n_calls=15,
                                  repeats_per_call=3, seed=4)
        ctl = ctl_mod.AdaptiveController(plan, ctl_mod.AdaptiveConfig(min_results=10, seed=4))
        rep = eng_mod.ExecutionEngine(be_mod.LambdaLikeBackend(_workloads(plat_mod), seed=4),
                                      eng_mod.EngineConfig(parallelism=40)).run(
            plan, observer=ctl)
        return rep, ctl.analyzer.analyze()
    got, got_changes = run(controller, rmit, backends, engine, platform)
    ref, ref_changes = run(jax_controller, jax_rmit, jax_backends, jax_engine, jax_platform)
    assert got.skipped > 0 and got_changes
    assert canon(got) == canon(ref)
    assert canon(got_changes) == canon(ref_changes)


def test_engine_factory_has_the_scalar_engine_only():
    """The factory gives the vectorised engine for "fast" and by default,
    as in JAX, and the scalar one for "reference"."""
    be = backends.LambdaLikeBackend(_workloads(platform))
    assert engine_vec._DEFAULT_ENGINE == "fast"
    assert type(engine_vec.make_engine(be)) is engine_vec.VectorEngine
    assert type(engine_vec.make_engine(be, engine="fast")) is engine_vec.VectorEngine
    assert type(engine_vec.make_engine(be, engine="reference")) is engine.ExecutionEngine
    with pytest.raises(ValueError, match="unknown engine"):
        engine_vec.make_engine(be, engine="turbo")
    with pytest.raises(ValueError, match="unknown engine"):
        engine_vec.set_default_engine("turbo")
    try:
        engine_vec.set_default_engine("reference")
        assert type(engine_vec.make_engine(be)) is engine.ExecutionEngine
    finally:
        engine_vec.set_default_engine("fast")
    assert type(engine_vec.make_engine(be)) is engine_vec.VectorEngine


def test_fault_injection_is_not_ported_yet():
    """``chaos=`` now wraps the backend in the port's ``ChaosBackend``; a run
    through it equals JAX's, fault counts included."""
    from repro.faas import chaos as jax_chaos
    from repro_torch.faas import chaos
    backend = platform.make_provider_backend(_workloads(platform), "gcf", chaos=None)
    assert backend.profile is backends.GCF_PROFILE

    def run(plat_mod, eng_mod, chaos_mod, rmit_mod):
        be = plat_mod.make_provider_backend(_workloads(plat_mod), "gcf", seed=4,
                                            chaos=chaos_mod.moderate_chaos(seed=3))
        assert isinstance(be, chaos_mod.ChaosBackend) and be.inner.profile.name == "gcf"
        rep = eng_mod.ExecutionEngine(be, eng_mod.EngineConfig(parallelism=40,
                                                               max_retries=1)).run(
            _plan(rmit_mod))
        return rep, dict(be.stats), be.ground_truth()
    got = run(platform, engine, chaos, rmit)
    ref = run(jax_platform, jax_engine, jax_chaos, jax_rmit)
    assert sum(got[1].values()) > 0
    assert canon(got) == canon(ref)


@pytest.mark.parametrize("run, key", [
    (lambda suite: experiment.run_faas_experiment("baseline", suite, seed=0), "baseline_seed0"),
    (lambda suite: experiment.run_vm_experiment("original", suite), "vm_original"),
], ids=["faas-baseline", "vm-original"])
def test_experiment_matches_seed_golden(obs_mode, run, key):  # noqa: F811
    """tests/test_engine_backends.py's seed goldens in the port: the same
    executed, failed and changed sets under each observability mode of the
    port's context."""
    with open(GOLDEN) as f:
        golden = json.load(f)[key]
    res = run(experiment.victoriametrics_like_suite())
    assert res.report.executed_benchmarks == golden["executed"]
    assert res.report.failed_benchmarks == golden["failed"]
    assert sorted(n for n, c in res.changes.items() if c.changed) == golden["changed"]
