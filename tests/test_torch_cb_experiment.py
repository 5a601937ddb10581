"""The port's experiment layer (``core/experiment.py``) and memory autotuner
(``core/autotune.py``) against the JAX package's, at small sizes.

Every experiment is virtual-time and seeded, and both sides run the same
NumPy code, so results must agree bit for bit, those that run through the
benchmarking service included.
"""
import dataclasses
import importlib
import json
from collections.abc import Sequence

import numpy as np
import pytest

SIDES = ("repro", "repro_torch")


class _Mods:
    def __init__(self, pkg):
        for name in ("core.experiment", "core.autotune", "core.controller", "faas.backends",
                     "faas.chaos", "faas.platform", "cb.registry", "service.planner"):
            setattr(self, name.split(".")[-1], importlib.import_module(f"{pkg}.{name}"))


MODS = {pkg: _Mods(pkg) for pkg in SIDES}
PORT = MODS["repro_torch"]


def canon(obj):
    """Exact, order-keeping text of a nest of dataclasses, dicts, sequences
    and floats: two results are bit-identical iff their texts are equal."""
    def norm(o):
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return [type(o).__name__, {f.name: norm(getattr(o, f.name))
                                       for f in dataclasses.fields(o)}]
        if isinstance(o, dict):
            return [[norm(k), norm(v)] for k, v in o.items()]
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, Sequence) and not isinstance(o, str):
            return [norm(v) for v in o]
        if isinstance(o, np.generic):
            return o.item()
        return o
    return json.dumps(norm(obj), default=repr)


def both(fn):
    """``fn(mods)`` on each side; asserts the results agree bit for bit and
    returns the port's."""
    got, ref = fn(PORT), fn(MODS["repro"])
    assert canon(got) == canon(ref)
    return got


def _small(m, n=8):
    return {f"b{i}": m.platform.SimWorkload(name=f"b{i}", base_seconds=0.4 + 0.3 * i,
                                            effect_pct=4.0 * (i % 2), setup_seconds=3.0)
            for i in range(n)}


# ------------------------------------------------------------------ suites
@pytest.mark.parametrize("seed", [42, 0, 7])
def test_victoriametrics_like_suite_matches_jax(seed):
    suite = both(lambda m: m.experiment.victoriametrics_like_suite(seed))
    assert len(suite) == PORT.experiment.N_BENCHMARKS == 106
    both(lambda m: m.experiment.aa_suite(m.experiment.victoriametrics_like_suite(seed)))


def test_synthetic_suite_default_is_the_paper_suite():
    names = both(lambda m: (m.registry.SyntheticSuite().benchmark_names(),
                            m.registry.SyntheticSuite().measurable_names(),
                            m.registry.SyntheticSuite().quiet_names()))
    assert len(names[0]) == 106 and len(names[1]) == 91


# ------------------------------------------------------------- experiments
@pytest.mark.parametrize("provider", ["lambda", "gcf", "azure"])
def test_run_faas_experiment_matches_jax(provider):
    def run(m):
        suite = m.experiment.victoriametrics_like_suite()
        res = m.experiment.run_faas_experiment("b", suite, n_calls=6, seed=2,
                                               provider=provider, max_retries=1)
        return res, m.experiment.detection_accuracy(suite, res.changes)
    res, acc = both(run)
    assert res.n_executed > 80 and 0 < acc <= 106


def test_run_faas_experiment_engines_agree():
    def run(engine):
        suite = PORT.experiment.victoriametrics_like_suite()
        return PORT.experiment.run_faas_experiment("b", suite, n_calls=5, seed=1,
                                                   engine=engine)
    assert canon(run("fast")) == canon(run("reference"))


def test_run_adaptive_experiment_matches_jax():
    def run(m):
        suite = m.experiment.victoriametrics_like_suite()
        return m.experiment.run_adaptive_experiment(
            "a", suite, n_calls=10, seed=3,
            adaptive_cfg=m.controller.AdaptiveConfig(stop_min_results=6))
    res = both(run)
    assert res.adaptive.invocations_skipped > 0


def test_run_vm_experiment_matches_jax():
    res = both(lambda m: m.experiment.run_vm_experiment(
        "vm", m.experiment.victoriametrics_like_suite(), n_trials=12, seed=1))
    assert res.report.wall_seconds > 0


def test_run_chaos_robustness_experiment_matches_jax():
    cells = both(lambda m: m.experiment.run_chaos_robustness_experiment(
        providers=("lambda",), intensities=(0.0, 1.0), seeds_per_cell=1, n_calls=8))
    calm, mod = cells
    assert calm.lost == 0 and calm.chaos_stats == {}
    assert sum(mod.chaos_stats.values()) > 0


def test_run_pipeline_experiment_matches_jax():
    res = both(lambda m: m.experiment.run_pipeline_experiment(
        "gcf", n_commits=5, seed=1, n_calls=6))
    assert set(res.reports) == {"full", "selective", "selective_cached"}
    assert all(0.0 <= a <= 106 for a in res.accuracy.values())


def test_pipeline_detection_accuracy_matches_jax():
    def run(m):
        res = m.experiment.run_pipeline_experiment("lambda", n_commits=4, seed=2, n_calls=5,
                                                   modes=("selective",))
        measurable = m.registry.SyntheticSuite().measurable_names()
        return [m.experiment.pipeline_detection_accuracy(res.commits, res.reports["selective"],
                                                         measurable, floor_pct=f)
                for f in (1.0, 2.0, 5.0)]
    both(run)


def test_service_experiments_match_jax():
    """The experiments that run through the benchmarking service: the
    multi-tenant run, one planner candidate executed on the platform model
    it priced (a FaaS one and the VM fleet), and the Pareto sweep."""
    def run(m):
        e = m.experiment
        suite = e.victoriametrics_like_suite()
        multi = e.run_multi_tenant_experiment(2, n_commits=2, n_calls=3)
        planner = m.planner
        cands = planner.DeadlineCostPlanner().candidates(suite, seed=0)
        faas = min((c for c in cands if c.provider == "lambda"),
                   key=lambda c: c.predicted_cost_usd)
        vm = next(c for c in cands if c.provider == planner.VM_PROVIDER)
        executed = [e._execute_candidate(c, suite, seed=0) for c in (faas, vm)]
        pareto = e.run_service_pareto_experiment(max_rows=2)
        return multi, [(r.name, r.report, r.changes) for r in executed], pareto
    multi, executed, pareto = both(run)
    assert multi.n_tenants == 2 and multi.jobs > 0 and multi.total_invocations > 0
    assert all(report.pairs for _, report, _ in executed)
    assert pareto.rows and pareto.chosen is not None and pareto.n_candidates > len(pareto.rows)


# ---------------------------------------------------------------- autotune
def test_autotune_memory_matches_jax():
    res = both(lambda m: m.autotune.autotune_memory(_small(m, 6), n_calls=10, seed=3))
    assert set(res.memory_map) == {f"b{i}" for i in range(6)}
    assert 0.0 <= res.detections_consistent <= 1.0


@pytest.mark.parametrize("provider", ["lambda", "gcf", "azure"])
def test_probe_memory_curve_matches_jax(provider):
    def run(m):
        profile = m.backends.PROVIDER_PROFILES[provider]
        curve = m.autotune.probe_memory_curve(_small(m)["b3"], profile, seed=2)
        fs = m.autotune.probe_memory_curve(
            m.platform.SimWorkload(name="f", base_seconds=1.0, effect_pct=0.0,
                                   fs_write=True), profile)
        return curve, fs, [curve.predict_invocation_cost(profile, mb, 3)
                           for mb in (512, 1024, 2048, 3008)], \
            curve.knee(profile, (512, 1024, 1792, 2048, 3008))
    curve, fs, _, _ = both(run)
    assert curve is not None and fs is None


def test_autotune_suite_memory_matches_jax():
    plan = both(lambda m: m.autotune.autotune_suite_memory(
        _small(m), m.backends.PROVIDER_PROFILES["lambda"],
        candidate_mb=(512, 1024, 1792, 2048), seed=1))
    assert plan.curves and all(mb >= 1792 for mb in plan.memory_map.values())
