"""The port's observability sensors (``repro_torch.obs``: tracer, metrics,
flight recorder, report, the ``Observability`` bundle) against the JAX
package's, on the cases of tests/test_obs.py.

Both sides run the same NumPy code, so the same events, samples and runs
must give the same Chrome documents, sketch buckets, snapshots, dumps and
rendered text, bit for bit.

This file also holds the port's ``obs_mode`` fixture (tests/conftest.py's
drives ``repro.obs`` only) and ``restore_contexts``; the port's golden and
command-line tests import them from here.
"""
import importlib
import json

import numpy as np
import pytest

SIDES = ("repro", "repro_torch")


class _Mods:
    def __init__(self, pkg):
        self.obs = importlib.import_module(f"{pkg}.obs")
        for name in ("obs.trace", "obs.metrics", "obs.recorder", "obs.report",
                     "core.experiment", "faas.engine", "faas.engine_vec", "service"):
            setattr(self, name.split(".")[-1], importlib.import_module(f"{pkg}.{name}"))


MODS = {pkg: _Mods(pkg) for pkg in SIDES}
PORT = MODS["repro_torch"]


def both(fn):
    """``fn(mods)`` on each side; asserts the results are equal as JSON and
    returns the port's."""
    got, ref = fn(PORT), fn(MODS["repro"])
    assert json.dumps(got, sort_keys=True, default=repr) == \
        json.dumps(ref, sort_keys=True, default=repr)
    return got


@pytest.fixture
def restore_contexts():
    """Put back both packages' process-wide observability context and
    default engine: the command line and ``BenchmarkService`` install them
    and never restore them."""
    saved = [(m.obs, m.obs.get_obs(), m.engine_vec, m.engine_vec._DEFAULT_ENGINE)
             for m in MODS.values()]
    yield
    for obs, ctx, ev, engine in saved:
        obs.set_obs(ctx)
        ev.set_default_engine(engine)


@pytest.fixture(params=["null", "recording", "monitoring"])
def obs_mode(request):
    """tests/conftest.py's ``obs_mode`` on the port's context: the test runs
    under each observability mode, and on teardown a recording run must
    have produced a non-empty, schema-valid Chrome trace and a monitoring
    run a well-formed health verdict."""
    obs_pkg = PORT.obs
    obs = getattr(obs_pkg.Observability, request.param)()
    with obs_pkg.use_obs(obs):
        yield obs
    if obs.enabled:
        doc = obs.tracer.to_chrome_trace()
        assert len(doc["traceEvents"]) > 0, "recording run emitted no trace events"
        assert obs_pkg.validate_chrome_trace(doc) == []
    if obs.monitor is not None:
        health = obs.health()
        assert health["verdict"] in ("healthy", "warn", "breach")
        assert isinstance(health["slos"], list)


# ------------------------------------------------------------------ tracer
def _events(m, tracer):
    tracer.span("invoke", cat="invoke", ts=1.5, dur=0.25, pid="fleet:lambda",
                tid="slot000", args={"job": "j1"})
    tracer.instant("cold_start", cat="cold", ts=1.5, pid="fleet:lambda", tid="slot000")
    tracer.span("job", cat="job", ts=0.0, dur=3.0, pid="tenants", tid="tenant00")
    rng = np.random.default_rng(4)
    for i in range(40):
        tracer.span(f"s{i % 5}", cat="wave", ts=float(rng.uniform(0, 900)),
                    dur=float(rng.uniform(0, 30)), pid=f"fleet:{('lambda', 'gcf')[i % 2]}",
                    tid=f"slot{i % 7:03d}", args={"n": int(rng.integers(1, 64))})
    return tracer.to_chrome_trace()


def test_null_tracer_is_inert():
    def probe(m):
        tr = m.trace.NullTracer()
        tr.span("x", cat="c", ts=0.0, dur=1.0, pid="p", tid="t")
        tr.instant("y", cat="c", ts=0.0, pid="p", tid="t")
        return tr.enabled, tr.events(), tr.to_chrome_trace()
    assert both(probe)[:2] == (False, [])


def test_chrome_export_of_the_same_events_matches_jax():
    doc = both(lambda m: _events(m, m.trace.RecordingTracer()))
    assert PORT.trace.validate_chrome_trace(doc) == []
    span = next(e for e in doc["traceEvents"] if e["ph"] == "X" and e["name"] == "invoke")
    assert span["ts"] == pytest.approx(1.5e6) and span["dur"] == pytest.approx(0.25e6)
    inst = next(e for e in doc["traceEvents"] if e["ph"] == "i")
    assert (inst["pid"], inst["tid"]) == (span["pid"], span["tid"])


@pytest.mark.parametrize("doc", [
    [], {}, {"traceEvents": "x"},
    {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 1, "ts": 0.0},
                     {"ph": "i", "name": "b", "pid": "one", "tid": 1, "ts": 0.0},
                     {"ph": "X", "name": "c", "pid": 1, "tid": 1, "ts": -5, "dur": 1}]},
    {"traceEvents": [{"ph": "Q", "name": "a", "pid": 1, "tid": 1, "ts": 0.0},
                     {"name": "b", "pid": 1, "tid": 1, "ts": 0.0},
                     {"ph": "X", "pid": 1, "tid": 1, "ts": 0.0, "dur": -1},
                     {"ph": "M", "name": "process_name", "pid": 1, "args": {}}]},
], ids=["list", "empty", "events-not-a-list", "three-faults", "phases-names-durations"])
def test_validate_chrome_trace_on_malformed_documents(doc):
    errors = both(lambda m: m.trace.validate_chrome_trace(doc))
    assert errors


def test_write_chrome_trace_writes_the_same_file(tmp_path):
    def write(m):
        path = tmp_path / f"{m.obs.__name__}.json"
        m.trace.write_chrome_trace(_events(m, m.trace.RecordingTracer()), str(path))
        return path.read_text()
    text = both(write)
    assert PORT.trace.validate_chrome_trace(json.loads(text)) == []


# ----------------------------------------------------------------- metrics
def test_quantile_sketch_buckets_match_jax():
    vals = np.random.default_rng(3).lognormal(0.0, 2.0, size=2000)

    def probe(m):
        sk = m.metrics.QuantileSketch()
        for v in vals:
            sk.observe(float(v))
        sk.observe(0.0)
        return sk.buckets, sk.summary(), [sk.quantile(q) for q in (0.0, 0.5, 0.99, 1.0)]
    buckets, summary, _ = both(probe)
    assert summary["count"] == 2001 and len(buckets) > 10


@pytest.mark.parametrize("seed", [3, 11])
def test_observe_array_matches_the_scalar_loop_and_jax(seed):
    vals = np.random.default_rng(seed).uniform(1e-7, 50.0, size=997)

    def probe(m):
        a, b = m.metrics.QuantileSketch(), m.metrics.QuantileSketch()
        for v in vals:
            a.observe(float(v))
        b.observe_array(vals)
        assert a.buckets == b.buckets and a.count == b.count
        assert (a.vmin, a.vmax) == (b.vmin, b.vmax)
        return b.buckets, b.count, b.total, a.total
    both(probe)


def _registry(m):
    rng = np.random.default_rng(7)
    mx = m.metrics.MetricsRegistry()
    for i in range(200):
        t = f"t{i % 3}"
        p = ("lambda", "gcf")[i % 2]
        mx.inc("service.invocations", float(rng.integers(1, 4)), tenant=t, provider=p)
        mx.inc("engine.invocations", 1.0, provider=p)
        mx.observe("engine.latency_s", float(rng.lognormal(0.0, 1.0)), provider=p,
                   benchmark=f"b{i % 5}")
        mx.set_gauge("engine.slot_utilization", float(rng.uniform()), provider=p)
        mx.window("err", 60.0, provider=p).observe(float(i) * 7.5, float(rng.uniform() < 0.1))
    mx.inc_seq("service.billed_s", list(rng.uniform(0, 3, 50)), tenant="t0")
    mx.observe_many("engine.latency_s", list(rng.uniform(0, 3, 50)), provider="azure",
                    benchmark="b0")
    return mx


def test_registry_snapshot_matches_jax(tmp_path):
    def probe(m):
        mx = _registry(m)
        path = tmp_path / f"{m.obs.__name__}.json"
        mx.to_json(str(path))
        return (mx.snapshot(), path.read_text(),
                mx.counter_total("service.invocations", tenant="t1"),
                mx.label_values("tenant"), mx.gauge("engine.slot_utilization", provider="gcf"))
    snap, _, total, tenants, _ = both(probe)
    assert snap["schema"] == 1 and total > 0 and tenants == ["t0", "t1", "t2"]


def test_report_renders_what_jax_renders(tmp_path, capsys):
    def probe(m):
        snap = _registry(m).snapshot()
        path = tmp_path / f"{m.obs.__name__}.json"
        path.write_text(json.dumps(snap))
        code = m.report.main([str(path)])
        return (m.report.render_report(snap), m.report.merge_latency_sketches(snap), code,
                capsys.readouterr().out)
    text, merged, code, _ = both(probe)
    assert code == 0 and "t2" in text and "lambda" in text and set(merged) == {"azure", "gcf", "lambda"}


# ---------------------------------------------------------------- recorder
def test_flight_recorder_bounds_match_jax():
    def probe(m):
        rec = m.recorder.FlightRecorder(capacity=4, max_dumps=2)
        tr = m.trace.RecordingTracer(recorder=rec)
        for i in range(10):
            tr.instant(f"e{i}", cat="c", ts=float(i), pid="p", tid="t")
        d = rec.dump("anomaly", ts=9.0, context={"k": "v"})
        return d, rec.dump("again"), rec.dump("capped"), rec.dumps_suppressed, rec.snapshot()
    d, again, capped, suppressed, snap = both(probe)
    assert d["n_events"] == 4 and again is not None and capped is None
    assert suppressed == 1 and len(snap["dumps"]) == 2


# ------------------------------------------------------- bundle and service
@pytest.mark.parametrize("mode", ["null", "recording", "monitoring"])
def test_observability_of_a_service_run_matches_jax(mode, tmp_path):
    """Every mode of the bundle over the same service run: the trace, the
    metrics, the dumps and the health verdict equal JAX's, and the metrics
    agree with the service's own accounting."""
    def probe(m):
        full = m.experiment.victoriametrics_like_suite()
        wl = {k: v for k, v in sorted(full.items())[:8]
              if not v.fs_write and v.base_seconds < 10.0}
        obs = getattr(m.obs.Observability, mode)()
        with m.obs.use_obs(obs):
            svc = m.service.BenchmarkService(m.service.ServiceConfig(parallelism=8, seed=3))
            svc.submit(m.service.Job(job_id="poor", tenant="broke", workloads=wl, n_calls=6,
                                     repeats_per_call=2, seed=5, budget_usd=1e-9))
            svc.submit(m.service.Job(job_id="rich", tenant="ok", workloads=wl, n_calls=4,
                                     repeats_per_call=2, seed=6))
            rep = svc.run()
        paths = {k: tmp_path / f"{m.obs.__name__}.{k}.json" for k in ("trace", "dumps")}
        obs.export_trace(str(paths["trace"]))
        obs.export_dumps(str(paths["dumps"]))
        assert obs.metrics.counter_total("service.invocations") == (
            rep.total_invocations if obs.enabled else 0.0)
        return (rep.digest(), rep.preempted_jobs, obs.metrics.snapshot(), obs.health(),
                {k: p.read_text() for k, p in paths.items()})
    digest, preempted, snap, health, files = both(probe)
    assert preempted == ["poor"]
    if mode != "null":
        dumps = json.loads(files["dumps"])["dumps"]
        assert any(d["reason"] == "preemption" and d["context"].get("tenant") == "broke"
                   for d in dumps)
    assert health["verdict"] in ("healthy", "warn", "breach")


def test_infeasible_plan_dumps_flight_record():
    def probe(m):
        full = m.experiment.victoriametrics_like_suite()
        wl = {k: v for k, v in sorted(full.items())[:6]}
        planner = m.service.DeadlineCostPlanner(m.service.PlannerConfig())
        with m.obs.use_obs(m.obs.Observability.recording()) as obs:
            with pytest.raises(m.service.InfeasiblePlanError):
                planner.plan(wl, deadline_s=0.001, budget_usd=1e-12)
        return obs.metrics.counter_total("planner.infeasible"), obs.recorder.snapshot()
    count, snap = both(probe)
    assert count == 1.0 and any(d["reason"] == "infeasible_plan" for d in snap["dumps"])
