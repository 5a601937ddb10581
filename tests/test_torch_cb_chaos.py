"""The port's fault injection (``faas/chaos.py``) and performance regimes
(``faas/traces.py``) against the JAX package's, on the scenarios of
tests/test_chaos.py and tests/test_chaos_identity.py.

Fault injection is a pure function of (seed, config, invocation), and both
sides run the same NumPy code, so every report, fault count and
ground-truth log must agree bit for bit; at zero intensity the wrapper is
an exact identity in the port too.
"""
import dataclasses
import importlib
import json
import os
from collections.abc import Sequence

import numpy as np
import pytest

from test_torch_obs import obs_mode  # noqa: F401 (fixture)

SIDES = ("repro", "repro_torch")
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_seed_baseline.json")


class _Mods:
    def __init__(self, pkg):
        for name in ("core.rmit", "core.controller", "core.experiment", "faas.backends",
                     "faas.chaos", "faas.engine", "faas.platform", "faas.traces", "cb"):
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


def _suite(m, n=4, **kw):
    kw.setdefault("setup_seconds", 1.0)
    return {f"b{i}": m.platform.SimWorkload(name=f"b{i}", base_seconds=0.4 + 0.2 * i,
                                            effect_pct=6.0 * (i % 2), **kw)
            for i in range(n)}


def _run(m, suite, chaos=None, *, n_calls=5, repeats=2, parallelism=4, max_retries=0,
         seed=3, observer=None):
    plan = m.rmit.make_plan(sorted(suite), n_calls=n_calls, repeats_per_call=repeats,
                            seed=seed)
    backend = m.backends.SimFaaSBackend(suite, seed=seed)
    if chaos is not None:
        backend = m.chaos.ChaosBackend(backend, chaos)
    rep = m.engine.ExecutionEngine(backend, m.engine.EngineConfig(
        parallelism=parallelism, max_retries=max_retries)).run(plan, observer=observer)
    stats = dict(backend.stats) if chaos is not None else {}
    truth = backend.ground_truth() if chaos is not None else []
    return rep, stats, truth


def _only(m, kind, rate, **kw):
    return m.chaos.ChaosConfig(intensity=1.0, seed=9,
                               faults=(m.chaos.FaultSpec(kind, rate=rate, **kw),))


# ----------------------------------------------------------------- traces
def test_traces_answer_as_jax_does():
    ts = np.linspace(-300.0, 900.0, 241)

    def probe(m):
        tr = m.traces
        key = tr.instance_key("i42")
        diurnal = tr.DiurnalTrace(amplitude=0.1, period_s=100.0)
        spike = tr.ColdSpikeTrace(multiplier=5.0, period_s=100.0, window_s=10.0)
        region = tr.RegionTrace(n_regions=3, sigma=0.1, seed=4)
        noisy = tr.NoisyNeighborTrace(burst_prob=0.8, epoch_s=100.0, mean_burst_s=50.0,
                                      slowdown=3.0, seed=11)
        step = tr.StepTrace(factor=1.5, t0_s=100.0, t1_s=400.0, region=1)
        return {"key": key,
                "diurnal": [diurnal.speed_factor(t) for t in ts],
                "spike": [spike.cold_factor(t) for t in ts],
                "region": [region.speed_factor(0.0, k) for k in range(64)],
                "noisy": [noisy.speed_factor(t, key) for t in ts],
                "noisy_at_0": [noisy.active(0.0, k) for k in range(200)],
                "step": [step.speed_factor(t, k) for t in ts for k in range(4)],
                "scaled": [diurnal.scaled(0.0).speed_factor(25.0),
                           spike.scaled(0.0).cold_factor(5.0),
                           region.scaled(0.0).speed_factor(0.0, 7),
                           noisy.scaled(0.0).active(17.0, key)]}
    got = both(probe)
    assert 3.0 in got["noisy"] and set(got["noisy"]) <= {1.0, 3.0}
    assert len(set(got["region"])) == 3 and any(got["noisy_at_0"])
    assert got["scaled"] == [1.0, 1.0, 1.0, False]


def test_storm_windows_and_cost_model():
    def probe(m):
        ch = m.chaos
        spec = ch.FaultSpec(ch.TIMEOUT_STORM, rate=1.0, period_s=100.0, window_s=10.0)
        cfg = ch.ChaosConfig(intensity=1.0, faults=(ch.FaultSpec(ch.LOSS, rate=0.1),
                                                    ch.FaultSpec(ch.BILLING, rate=0.5,
                                                                 magnitude=3.0)))
        return {"windows": [spec.in_window(t) for t in (5.0, 50.0, 205.0)],
                "duty": spec.duty_cycle(),
                "cost": [cfg.cost_model(max_retries=r) for r in (0, 1, 3)],
                "zero": cfg.scaled(0.0).cost_model(max_retries=3),
                "moderate": ch.moderate_chaos(seed=4)}
    got = both(probe)
    assert got["windows"] == [True, False, True]
    assert got["cost"][1].expected_attempts == pytest.approx(1.1)
    assert got["zero"].expected_attempts == 1.0


def test_chaos_refuses_realtime_backends():
    for m in MODS.values():
        with pytest.raises(ValueError):
            m.chaos.ChaosBackend(m.backends.LocalDuetBackend({}), m.chaos.moderate_chaos())


# ------------------------------------------------------------- faults
def test_fault_slots_are_independent():
    def run(m):
        ch = m.chaos
        loss = _run(m, _suite(m), _only(m, ch.LOSS, 0.4))
        both_faults = _run(m, _suite(m), ch.ChaosConfig(
            intensity=1.0, seed=9, faults=(ch.FaultSpec(ch.LOSS, rate=0.4),
                                           ch.FaultSpec(ch.DUPLICATE, rate=0.5,
                                                        magnitude=1))))
        return loss, both_faults
    (rep_loss, s_loss, _), (rep_both, s_both, _) = both(run)
    assert s_loss["lost"] == s_both["lost"] and rep_loss.lost == rep_both.lost
    assert rep_loss.billed_seconds == rep_both.billed_seconds
    assert rep_both.duplicates_dropped > 0


def test_duplicates_never_double_bill_or_double_deliver():
    def run(m):
        deliveries = {}

        class Counting(m.engine.EngineObserver):
            def on_result(self, done):
                key = (done.invocation.benchmark, done.invocation.call_index)
                deliveries[key] = deliveries.get(key, 0) + 1

        plain = _run(m, _suite(m))
        rep = _run(m, _suite(m), _only(m, m.chaos.DUPLICATE, 1.0, magnitude=2),
                   observer=Counting())
        return plain, rep, sorted(deliveries.items())
    (plain, _, _), (rep, stats, _), deliveries = both(run)
    assert rep.billed_seconds == plain.billed_seconds
    assert rep.cost_dollars == plain.cost_dollars
    assert all(n == 1 for _, n in deliveries)
    assert rep.duplicates_dropped == 2 * rep.invocations_done
    assert stats["duplicates_injected"] == rep.invocations_done


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_heavy_losses_never_deadlock_the_engine(seed):
    def run(m):
        suite = _suite(m, 3)
        cfg = m.chaos.ChaosConfig(intensity=1.0, seed=seed,
                                  faults=(m.chaos.FaultSpec(m.chaos.LOSS, rate=0.6),))
        plan = m.rmit.make_plan(sorted(suite), n_calls=6, repeats_per_call=2, seed=1)
        backend = m.chaos.ChaosBackend(m.backends.SimFaaSBackend(suite, seed=1), cfg)
        ctl = m.controller.AdaptiveController(plan, m.controller.AdaptiveConfig(
            min_results=2, stop_min_results=4, seed=1))
        rep = m.engine.ExecutionEngine(backend, m.engine.EngineConfig(
            parallelism=3, max_retries=2)).run(plan, observer=ctl)
        return rep, ctl.summary(), dict(backend.stats), len(plan.invocations)
    rep, summary, stats, planned = both(run)
    assert (rep.invocations_done + rep.invocations_failed + rep.skipped
            == planned + summary.invocations_added)
    assert rep.lost == stats.get("lost", 0)


def test_zombie_retry_redraws_cold_start():
    def run(m):
        suite = {"b0": m.platform.SimWorkload(name="b0", base_seconds=0.3, effect_pct=0.0,
                                              setup_seconds=0.5)}
        return _run(m, suite, _only(m, m.chaos.ZOMBIE, 1.0), n_calls=4, parallelism=1,
                    max_retries=1)
    rep, stats, _ = both(run)
    assert rep.invocations_done == 4 and rep.failed_benchmarks == []
    assert stats["zombie_hits"] == 3 and rep.cold_starts == 4 and rep.retries == 3


def test_timeout_storms_are_transient_not_condemning():
    rep, stats, truth = both(lambda m: _run(m, _suite(m, 3),
                                            _only(m, m.chaos.TIMEOUT_STORM, 1.0)))
    assert rep.invocations_done == 0 and rep.failed_benchmarks == []
    assert rep.timeouts == rep.invocations_failed == stats["storm_timeouts"] > 0
    assert all(b == 20.0 for b in rep.billed_seconds)
    assert truth


def test_billing_anomalies_inflate_cost_not_durations():
    def run(m):
        return _run(m, _suite(m)), _run(m, _suite(m), _only(m, m.chaos.BILLING, 1.0,
                                                            magnitude=3.0))
    (plain, _, _), (rep, stats, _) = both(run)
    assert rep.billed_seconds == plain.billed_seconds
    assert rep.wall_seconds == plain.wall_seconds
    assert rep.cost_dollars > plain.cost_dollars
    assert stats["billing_anomalies"] == len(plain.billed_seconds)


def test_neighbor_bursts_contaminate_pairs_asymmetrically():
    def run(m):
        cfg = m.chaos.ChaosConfig(
            intensity=1.0, seed=2,
            neighbor=m.traces.NoisyNeighborTrace(burst_prob=1.0, epoch_s=1e6,
                                                 mean_burst_s=1e6, slowdown=4.0, seed=2),
            neighbor_hit=0.5, neighbor_sigma=0.3)
        return _run(m, _suite(m, 2, run_sigma=0.02), cfg, n_calls=8)
    rep, stats, _ = both(run)
    assert stats["contaminated_invocations"] > 0
    diffs = [abs(p.v2_seconds / p.v1_seconds - 1.0) * 100 for p in rep.pairs]
    assert max(diffs) > 100.0


def test_moderate_chaos_ground_truth_matches_jax():
    def run(m):
        return _run(m, _suite(m, 6), m.chaos.moderate_chaos(seed=3), n_calls=10,
                    max_retries=1)
    rep, stats, truth = both(run)
    assert sum(stats.values()) > 0 and truth


# ------------------------------------------------------- zero intensity
def _zero(m):
    return m.chaos.moderate_chaos(seed=5).scaled(0.0)


def test_zero_intensity_config_is_inactive():
    assert not _zero(PORT).active and PORT.chaos.moderate_chaos(seed=0).active


def test_zero_intensity_replays_engine_golden_bit_for_bit(obs_mode):  # noqa: F811
    def run(m):
        suite = m.experiment.victoriametrics_like_suite()
        plain = m.experiment.run_faas_experiment("baseline", suite, seed=0)
        chaotic = m.experiment.run_chaos_experiment("baseline_chaos", suite, chaos=_zero(m),
                                                    seed=0, n_calls=15, max_retries=0)
        return plain, chaotic
    plain, chaotic = both(run)
    assert canon(chaotic.report) == canon(plain.report)
    with open(GOLDEN) as f:
        golden = json.load(f)["baseline_seed0"]
    assert chaotic.report.executed_benchmarks == golden["executed"]
    assert chaotic.report.failed_benchmarks == golden["failed"]
    assert sorted(n for n, c in chaotic.changes_naive.items() if c.changed) \
        == golden["changed"]


@pytest.mark.parametrize("provider", ["gcf", "azure"])
def test_zero_intensity_identity_on_other_providers(provider):
    def run(m):
        suite = m.experiment.victoriametrics_like_suite()
        plain = m.experiment.run_faas_experiment("p", suite, seed=3, provider=provider,
                                                 max_retries=1)
        chaotic = m.experiment.run_chaos_experiment("c", suite, provider=provider,
                                                    chaos=_zero(m), seed=3, n_calls=15,
                                                    max_retries=1)
        return plain.report, chaotic.report
    plain, chaotic = both(run)
    assert canon(plain) == canon(chaotic)


def test_zero_intensity_wrapper_delegates_backend_protocol():
    suite = PORT.experiment.victoriametrics_like_suite()
    inner = PORT.backends.SimFaaSBackend(suite, PORT.backends.PROVIDER_PROFILES["gcf"], seed=1)
    wrapped = PORT.chaos.ChaosBackend(inner, _zero(PORT))
    assert wrapped.pinned == inner.pinned and wrapped.keep_alive_s == inner.keep_alive_s
    assert wrapped.profile is inner.profile and wrapped.workloads is inner.workloads
    assert not getattr(wrapped, "realtime", False)
    wrapped = PORT.platform.make_provider_backend(suite, "gcf", chaos=_zero(PORT))
    assert isinstance(wrapped, PORT.chaos.ChaosBackend) and wrapped.inner.profile is \
        PORT.backends.GCF_PROFILE


def test_zero_intensity_service_replays_scheduler_golden(obs_mode):  # noqa: F811
    """The 16-tenant schedule digest replays through zero-intensity chaos
    fleets in the port, under each observability mode."""
    r = PORT.experiment.run_multi_tenant_experiment(16, provider="lambda", seed=34,
                                                    chaos=_zero(PORT))
    assert r.digest == "65e8852bf2dce3a7"      # tests/test_service_scheduler.py:19


def test_zero_intensity_pipeline_replays_stream_bit_for_bit(obs_mode):  # noqa: F811
    def run(m):
        base = m.cb.SyntheticSuite()
        commits, _ = m.cb.synthetic_stream(
            base.benchmark_names(), m.cb.StreamConfig(n_commits=4, seed=2),
            effectable=base.measurable_names(), drift_candidates=base.quiet_names())

        def stream(chaos):
            cfg = m.cb.PipelineConfig(provider="gcf", mode="selective_cached", n_calls=8,
                                      seed=2, chaos=chaos)
            rep = m.cb.Pipeline(m.cb.SyntheticSuite(base.workloads), cfg).run_stream(commits)
            return rep.commits, [str(e) for e in rep.events]
        return stream(None), stream(_zero(m))
    plain, chaotic = both(run)
    assert canon(plain) == canon(chaotic)


def test_nonzero_intensity_is_deterministic_per_seed():
    def run(m):
        suite = m.experiment.victoriametrics_like_suite()

        def one(chaos_seed):
            res = m.experiment.run_chaos_experiment(
                "d", suite, chaos=m.chaos.moderate_chaos(seed=chaos_seed), seed=4, n_calls=6,
                max_retries=1)
            return canon(res.report), res.chaos_stats
        return one(12), one(12), one(13)
    (d1, s1), (d2, s2), (d3, _) = both(run)
    assert d1 == d2 and s1 == s2 and d1 != d3 and sum(s1.values()) > 0


def test_pipeline_runs_under_chaos():
    def run(m):
        base = m.cb.SyntheticSuite()
        commits, _ = m.cb.synthetic_stream(
            base.benchmark_names(), m.cb.StreamConfig(n_commits=4, seed=6),
            effectable=base.measurable_names(), drift_candidates=base.quiet_names())
        cfg = m.cb.PipelineConfig(provider="lambda", mode="selective", n_calls=6, seed=6,
                                  chaos=m.chaos.moderate_chaos(seed=6))
        rep = m.cb.Pipeline(m.cb.SyntheticSuite(base.workloads), cfg).run_stream(commits)
        return rep.commits, rep.total_invocations
    commits, invocations = both(run)
    assert invocations > 0 and len(commits) == 3
