"""The port's vectorised engine (``VectorEngine``, ``PairSeq``, the fallback
log) against the JAX package's, on the cases of tests/test_engine_vec.py.

Both sides run the same NumPy code on the same seeds, so every report must
agree bit for bit: the port's fast engine with JAX's fast engine, and with
the port's own scalar engine.
"""
import importlib
import json
import math

import pytest

SIDES = ("repro", "repro_torch")


def _mods(pkg):
    m = {name: importlib.import_module(f"{pkg}.{name}")
         for name in ("core.experiment", "core.rmit", "faas.backends", "faas.chaos",
                      "faas.engine", "faas.engine_vec")}
    m["suite"] = m["core.experiment"].victoriametrics_like_suite()
    return m


MODS = {pkg: _mods(pkg) for pkg in SIDES}


def report_text(rep):
    """Exact text of an engine report: every pair, every billed second and
    every counter (floats by their shortest exact repr)."""
    out = {f: getattr(rep, f) for f in rep.__dataclass_fields__ if f != "pairs"}
    out["billed_seconds"] = list(out["billed_seconds"])
    out["pairs"] = [(p.benchmark, p.v1_seconds, p.v2_seconds, p.instance_id,
                     p.call_index, p.cold_start) for p in rep.pairs]
    return json.dumps(out, sort_keys=True)


def _plan(m, n_calls=6, seed=0):
    return m["core.rmit"].make_plan(sorted(m["suite"]), n_calls=n_calls,
                                    repeats_per_call=3, seed=seed)


def _run(pkg, make_backend, cfg=None, plan=None, start_s=0.0, fast=True):
    m = MODS[pkg]
    eng = m["faas.engine"]
    cfg = eng.EngineConfig(**cfg) if cfg is not None else None
    cls = m["faas.engine_vec"].VectorEngine if fast else eng.ExecutionEngine
    plan = plan(m) if plan is not None else _plan(m)
    return cls(make_backend(m), cfg).run(plan, start_s=start_s)


def _diff(make_backend, cfg=None, plan=None, start_s=0.0):
    """Port fast == JAX fast == port reference, bit for bit; returns the
    port's fast report."""
    got = _run("repro_torch", make_backend, cfg, plan, start_s)
    ref = _run("repro", make_backend, cfg, plan, start_s)
    scalar = _run("repro_torch", make_backend, cfg, plan, start_s, fast=False)
    assert report_text(got) == report_text(ref)
    assert report_text(got) == report_text(scalar)
    return got


def _profile(name):
    return lambda m: getattr(m["faas.backends"], f"{name.upper()}_PROFILE")


@pytest.mark.parametrize("provider", ["azure", "gcf", "lambda"])
def test_providers_bit_exact(provider):
    _diff(lambda m: m["faas.backends"].SimFaaSBackend(m["suite"], _profile(provider)(m),
                                                      seed=7))


@pytest.mark.parametrize("provider", ["azure", "gcf", "lambda"])
def test_memory_map_bit_exact(provider):
    def backend(m):
        mm = {name: (512 if i % 3 else 3008) for i, name in enumerate(sorted(m["suite"]))}
        return m["faas.backends"].SimFaaSBackend(m["suite"], _profile(provider)(m), seed=3,
                                                 memory_map=mm)
    _diff(backend)


def test_retries_bit_exact():
    rep = _diff(lambda m: m["faas.backends"].SimFaaSBackend(
        m["suite"], m["faas.backends"].GCF_PROFILE, seed=11), dict(max_retries=3))
    assert rep.retries > 0


def test_vm_backend_bit_exact():
    _diff(lambda m: m["faas.backends"].VMBackend(m["suite"], seed=5), dict(parallelism=3))


def test_small_parallelism_and_start_offset():
    sim = lambda m: m["faas.backends"].SimFaaSBackend(m["suite"], seed=1)  # noqa: E731
    _diff(sim, dict(parallelism=500), start_s=1000.0)
    _diff(sim, dict(parallelism=3), plan=lambda m: _plan(m, n_calls=2))


def test_hedging_bit_exact():
    rep = _diff(lambda m: m["faas.backends"].SimFaaSBackend(m["suite"], seed=2),
                dict(parallelism=4, hedge_after_factor=3.0), plan=lambda m: _plan(m, n_calls=4))
    assert rep.hedged > 0


def test_hedging_with_retries_bit_exact():
    _diff(lambda m: m["faas.backends"].SimFaaSBackend(
        m["suite"], m["faas.backends"].AZURE_PROFILE, seed=2),
        dict(parallelism=4, hedge_after_factor=3.0, max_retries=2),
        plan=lambda m: _plan(m, n_calls=4))


def test_zero_chaos_identity():
    def backend(m):
        ch = m["faas.chaos"]
        return ch.ChaosBackend(m["faas.backends"].SimFaaSBackend(m["suite"], seed=4),
                               ch.ChaosConfig(intensity=0.0))
    plain = _run("repro_torch", lambda m: m["faas.backends"].SimFaaSBackend(m["suite"], seed=4))
    ev = MODS["repro_torch"]["faas.engine_vec"]
    ev.reset_fallback_log()
    assert report_text(_diff(backend)) == report_text(plain)
    assert ev.get_fallback_log() == []          # unwrapped, not delegated


def test_active_chaos_delegates_and_matches():
    def backend(m):
        ch = m["faas.chaos"]
        cfg = ch.ChaosConfig(intensity=1.0, seed=9, faults=(ch.FaultSpec("loss", rate=0.05),))
        return ch.ChaosBackend(m["faas.backends"].SimFaaSBackend(m["suite"], seed=4), cfg)
    rep = _diff(backend, dict(max_retries=2), plan=lambda m: _plan(m, n_calls=3))
    assert rep.lost > 0


def test_observer_delegates_with_the_same_deliveries():
    def run(pkg):
        m = MODS[pkg]
        seen = []

        class Obs(m["faas.engine"].EngineObserver):
            def on_result(self, done):
                seen.append((done.invocation.benchmark, done.invocation.call_index))

        eng = m["faas.engine_vec"].VectorEngine(
            m["faas.backends"].SimFaaSBackend(m["suite"], seed=6))
        rep = eng.run(_plan(m, n_calls=2), observer=Obs())
        assert len(seen) == rep.invocations_done + rep.invocations_failed
        return report_text(rep), seen
    assert run("repro_torch") == run("repro")


def test_make_engine_factory():
    m = MODS["repro_torch"]
    ev, be = m["faas.engine_vec"], m["faas.backends"].SimFaaSBackend(m["suite"], seed=0)
    assert isinstance(ev.make_engine(be, engine="fast"), ev.VectorEngine)
    assert type(ev.make_engine(be, engine="reference")) is m["faas.engine"].ExecutionEngine
    with pytest.raises(ValueError):
        ev.make_engine(be, engine="turbo")


def test_pairseq_behaves_like_list_and_equals_jax():
    reps = {pkg: MODS[pkg]["faas.engine_vec"].VectorEngine(
        MODS[pkg]["faas.backends"].SimFaaSBackend(MODS[pkg]["suite"], seed=7)).run(
            _plan(MODS[pkg], n_calls=2)) for pkg in SIDES}
    ps = reps["repro_torch"].pairs
    assert isinstance(ps, MODS["repro_torch"]["faas.engine_vec"].PairSeq)
    lst = list(ps)
    assert ps == lst and len(ps) == len(lst)
    assert ps[0] == lst[0] and ps[-1] == lst[-1]
    assert [p for p in ps[:3]] == lst[:3]
    assert not math.isnan(sum(p.v1_seconds for p in ps))
    assert report_text(reps["repro_torch"]) == report_text(reps["repro"])


def test_fallback_log_gives_jax_reasons():
    """Each run that the fast engine hands to the scalar loop records the
    same reason in both packages."""
    def reasons(pkg):
        m = MODS[pkg]
        ev, be, eng, ch = m["faas.engine_vec"], m["faas.backends"], m["faas.engine"], \
            m["faas.chaos"]
        sim = be.SimFaaSBackend(m["suite"], seed=1)
        plan = _plan(m, n_calls=1)
        ev.reset_fallback_log()
        ev.VectorEngine(sim).run(plan)                                   # no fallback
        ev.VectorEngine(be.LocalDuetBackend({})).run(m["core.rmit"].make_plan(
            [], n_calls=1, seed=0))                                     # realtime
        active = ch.ChaosBackend(be.SimFaaSBackend(m["suite"], seed=1), ch.ChaosConfig(
            intensity=1.0, seed=3, faults=(ch.FaultSpec("loss", rate=0.01),)))
        ev.VectorEngine(active).run(plan)                                # active chaos
        ev.VectorEngine(sim).run(plan, observer=eng.EngineObserver())    # observer
        ev.VectorEngine(be.VMBackend(m["suite"], seed=1), eng.EngineConfig(parallelism=3)).run(
            plan, warm_pool=eng.WarmPool())                              # pinned pool
        ev.VectorEngine(be.SimFaaSBackend(m["suite"], seed=1), eng.EngineConfig(
            hedge_after_factor=3.0)).run(plan, observer=_WaveObserver(eng))
        log = ev.get_fallback_log()
        ev.reset_fallback_log()
        return log
    got = reasons("repro_torch")
    assert len(got) == 5 and got == reasons("repro")


def _WaveObserver(eng):
    class Obs(eng.EngineObserver):
        wave_eligible = True
    return Obs()
