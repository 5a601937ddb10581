"""The port's continuous-benchmarking pipeline (selection, cache, history,
detector, pipeline) against the JAX package's, on the synthetic workloads
and commit stream of tests/test_cb_pipeline.py.

Virtual time makes every number of a run deterministic, wall time and cost
included, and both sides run the same NumPy code: reports, events, cache
counts and history records must agree bit for bit.  Both sides run their
default engine, the vectorised one (``engine="fast"``).  A stream may also
run as jobs of the benchmarking service, and must then agree too.
"""
import json
import sqlite3
from dataclasses import asdict

import pytest

from repro import cb as jax_cb
from repro.faas.platform import SimWorkload as JaxSimWorkload
from repro_torch import cb
from repro_torch.cb import detect, history
from repro_torch.faas.platform import SimWorkload

N = 14


def canon(obj):
    """Exact, class-blind text of a nest of dataclasses, dicts, lists and
    floats: two results are bit-identical iff their texts are equal."""
    if hasattr(obj, "__dataclass_fields__"):
        obj = asdict(obj)
    return json.dumps(obj, sort_keys=True, default=repr)


def _workloads(cls):
    w = {}
    for i in range(N):
        name = f"s{i:02d}"
        w[name] = cls(name=name, base_seconds=0.4 + 0.05 * i, effect_pct=0.0,
                      run_sigma=0.02 + 0.002 * (i % 5), fs_write=(i == 13),
                      setup_seconds=2.0)
    return w


def _stream(mod, cls):
    w = _workloads(cls)
    names = sorted(w)
    measurable = [n for n in names if not w[n].fs_write]
    commits, drift = mod.synthetic_stream(
        names, mod.StreamConfig(n_commits=12, touched_lo=2, touched_hi=5,
                                drift_length=6, drift_per_commit_pct=2.0, seed=11),
        effectable=measurable, drift_candidates=measurable[:6])
    return w, commits, drift


def _run(mod, cls, mode, *, history=None, cache=None, **kw):
    w, commits, _ = _stream(mod, cls)
    cfg = mod.PipelineConfig(mode=mode, parallelism=50, max_staleness=3, seed=2, **kw)
    pipe = mod.Pipeline(mod.SyntheticSuite(dict(w)), cfg, history=history, cache=cache)
    return pipe, pipe.run_stream(commits)


@pytest.mark.parametrize("mode,kw", [("full", {}), ("selective", {}),
                                     ("selective_cached", {}),
                                     ("selective", dict(adaptive=True)),
                                     ("selective_cached", dict(provider="gcf"))])
def test_pipeline_reports_match_jax(mode, kw):
    pipe, rep = _run(cb, SimWorkload, mode, **kw)
    ref_pipe, ref = _run(jax_cb, JaxSimWorkload, mode, **kw)
    assert len(rep.commits) == 11 and rep.total_invocations > 0 and rep.events
    assert rep.total_wall_seconds > 0 and rep.total_cost > 0
    for run, ref_run in zip(rep.commits, ref.commits):
        assert canon(run) == canon(ref_run), run.commit_id
    assert canon(rep.events) == canon(ref.events)
    assert (rep.cache_hits, rep.cache_misses) == (ref.cache_hits, ref.cache_misses)
    assert canon(rep) == canon(ref)
    assert canon(pipe.history.records()) == canon(ref_pipe.history.records())


def test_jax_history_and_cache_read_back_by_the_port(tmp_path):
    """A history and a result cache that the JAX package wrote are read by
    the port record for record, and the port's pipeline carries on from
    them exactly as the JAX pipeline does."""
    hpath, cpath = str(tmp_path / "history.jsonl"), str(tmp_path / "cache.jsonl")
    _run(jax_cb, JaxSimWorkload, "selective_cached",
         history=jax_cb.HistoryStore(hpath), cache=jax_cb.ResultCache(cpath))
    back, ref = cb.HistoryStore(hpath), jax_cb.HistoryStore(hpath)
    assert len(back) == 12 * N and back.skipped_schema == 0
    assert history.SCHEMA_VERSION == jax_cb.history.SCHEMA_VERSION
    assert [canon(r) for r in back.records()] == [canon(r) for r in ref.records()]
    assert back.commits() == ref.commits()
    assert canon(back.series("s03", mode="selective_cached")) == \
        canon(ref.series("s03", mode="selective_cached"))

    back.to_sqlite(str(tmp_path / "port.sqlite"))
    ref.to_sqlite(str(tmp_path / "jax.sqlite"))
    dumps = []
    for name in ("port.sqlite", "jax.sqlite"):
        con = sqlite3.connect(str(tmp_path / name))
        try:
            dumps.append(list(con.iterdump()))
        finally:
            con.close()
    assert dumps[0] == dumps[1] and len(dumps[0]) > 12 * N

    # a second run over the same stream, one side each, from copies of the
    # persisted files: both read the same hits from the cache
    for suffix in ("port", "jax"):
        for p in (hpath, cpath):
            (tmp_path / f"{suffix}-{p.rsplit('/', 1)[1]}").write_text(open(p).read())
    _, rep = _run(cb, SimWorkload, "selective_cached",
                  history=cb.HistoryStore(str(tmp_path / "port-history.jsonl")),
                  cache=cb.ResultCache(str(tmp_path / "port-cache.jsonl")))
    _, ref_rep = _run(jax_cb, JaxSimWorkload, "selective_cached",
                      history=jax_cb.HistoryStore(str(tmp_path / "jax-history.jsonl")),
                      cache=jax_cb.ResultCache(str(tmp_path / "jax-cache.jsonl")))
    assert rep.cache_hits > 0 and canon(rep) == canon(ref_rep)
    assert (tmp_path / "port-history.jsonl").read_text() == \
        (tmp_path / "jax-history.jsonl").read_text()


def test_detector_scan_matches_jax():
    pipe, _ = _run(cb, SimWorkload, "full")
    ref_pipe, _ = _run(jax_cb, JaxSimWorkload, "full")
    for kw in ({}, dict(min_cumulative_pct=1.0), dict(z_threshold=2.0, step_clip_z=3.0)):
        got = detect.RegressionDetector(cb.DetectorConfig(**kw)).scan(pipe.history)
        ref = jax_cb.RegressionDetector(jax_cb.DetectorConfig(**kw)).scan(ref_pipe.history)
        assert got and canon(got) == canon(ref)


def _service_streams(mod, cls, service_mod):
    """Two tenants' streams through one service: tenant a through
    ``run_stream_service``'s parts (submit, run, collect), tenant b with a
    deadline and budget; returns both reports and their history."""
    w, commits, _ = _stream(mod, cls)
    service = service_mod.BenchmarkService(service_mod.ServiceConfig(parallelism=50, seed=2))
    out = []
    for tenant, kw in (("a", {}), ("b", dict(priority=2.0, deadline_s=900.0,
                                              budget_usd=0.5))):
        cfg = mod.PipelineConfig(mode="selective_cached", parallelism=50, max_staleness=3,
                                 seed=2)
        pipe = mod.Pipeline(mod.SyntheticSuite(dict(w)), cfg)
        out.append((pipe, pipe.submit_stream(commits, service, tenant=tenant, **kw)))
    rep = service.run()
    return rep.digest(), [(canon(p.collect_service(pend)),
                           [canon(r) for r in p.history.records()]) for p, pend in out]


def test_streams_through_the_service_match_jax():
    """A stream run as service jobs (``submit_stream``, ``collect_service``,
    ``run_stream_service``) gives JAX's reports and history, and the paper's
    suite (``SyntheticSuite()``) and either engine run and equal JAX."""
    from repro import service as jax_service
    from repro_torch import service
    got = _service_streams(cb, SimWorkload, service)
    assert got == _service_streams(jax_cb, JaxSimWorkload, jax_service)
    assert all(len(history) > 0 for _, history in got[1])
    _, commits, _ = _stream(cb, SimWorkload)
    single = {}
    for name, mod, cls, svc in (("port", cb, SimWorkload, service),
                                ("jax", jax_cb, JaxSimWorkload, jax_service)):
        pipe = mod.Pipeline(mod.SyntheticSuite(_workloads(cls)),
                            mod.PipelineConfig(mode="selective", seed=2))
        single[name] = canon(pipe.run_stream_service(
            _stream(mod, cls)[1], svc.BenchmarkService(svc.ServiceConfig(seed=2)),
            tenant="solo"))
    assert single["port"] == single["jax"]
    pipe = cb.Pipeline(cb.SyntheticSuite(_workloads(SimWorkload)),
                       cb.PipelineConfig(adaptive=True))
    with pytest.raises(ValueError, match="adaptive"):
        pipe.submit_stream(commits, service.BenchmarkService(service.ServiceConfig()))
    suite, ref_suite = cb.SyntheticSuite(), jax_cb.SyntheticSuite()
    assert len(suite.workloads) == 106
    assert canon(suite.workloads) == canon(ref_suite.workloads)
    for engine in ("fast", "reference"):
        _, rep = _run(cb, SimWorkload, "selective", engine=engine)
        _, ref = _run(jax_cb, JaxSimWorkload, "selective", engine=engine)
        assert canon(rep) == canon(ref)


def test_run_pipeline_resolves_the_suite_by_name():
    w, commits, _ = _stream(cb, SimWorkload)
    cfg = cb.PipelineConfig(mode="selective", parallelism=50, max_staleness=3, seed=2)
    rep = cb.run_pipeline("synthetic", commits, cfg, suite_kwargs={"workloads": dict(w)})
    _, same = _run(cb, SimWorkload, "selective")
    assert canon(rep) == canon(same)
