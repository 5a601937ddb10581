"""The port's live monitoring (``repro_torch.obs``: windowed rings,
detectors, SLO evaluators, incidents, the ``watch`` health tool) against
the JAX package's, on the cases of tests/test_obs_monitoring.py.

Monitoring runs on virtual time and only reads what the simulation
computed, so the same series and runs must give the same detector events
and states, alerts, incidents and health documents, bit for bit.
"""
import importlib
import json

import numpy as np
import pytest

SIDES = ("repro", "repro_torch")


class _Mods:
    def __init__(self, pkg):
        self.obs = importlib.import_module(f"{pkg}.obs")
        for name in ("obs.metrics", "obs.detectors", "obs.slo", "obs.incidents",
                     "obs.report", "obs.watch"):
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


# ------------------------------------------------- windowed-ring bulk path
@pytest.mark.parametrize("seed", range(4))
def test_windowed_ring_chunking_matches_the_loop_and_jax(seed):
    """``observe_many`` over seeded chunk boundaries equals the sequential
    ``observe`` loop, on both sides, out-of-order timestamps included."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 80))
    ts = rng.uniform(0.0, 600.0, n).tolist()
    vs = rng.uniform(-5.0, 50.0, n).tolist()
    cuts = sorted(set(rng.integers(0, n + 1, 4).tolist()) | {0, n})

    def probe(m):
        ref = m.metrics.WindowedRing(window_s=60.0)
        for t, v in zip(ts, vs):
            ref.observe(t, v)
        ring = m.metrics.WindowedRing(window_s=60.0)
        for a, b in zip(cuts, cuts[1:]):
            ring.observe_many(ts[a:b], vs[a:b])
        assert ring.series() == ref.series()
        return ring.series(), ring.window_indices(), ring.snapshot_rows()
    both(probe)


# -------------------------------------------------- detectors
_DETECTORS = {
    "ewma": lambda d: d.EWMAZScore(value="mean", z_on=4.0, z_off=1.5, warmup=4),
    "spike": lambda d: d.RateSpike(ratio=3.0, clear_ratio=1.5, min_count=4, warmup=2),
    "stuck": lambda d: d.StuckGauge(stuck_windows=4),
    "static": lambda d: d.StaticThreshold(value="mean", threshold=8.0),
}


@pytest.mark.parametrize("kind", sorted(_DETECTORS))
def test_detector_events_and_state_match_jax(kind):
    """A seeded series with a spike at the end: draining once at the end
    and at seeded times give the same events and state, as in JAX."""
    rng = np.random.default_rng(len(kind))
    vals = rng.uniform(0.0, 12.0, 40).tolist()
    window_s = 10.0
    samples = [(i * window_s + 1.0, v) for i, v in enumerate(vals)]
    samples += [(len(vals) * window_s + 1.0, 100.0), (len(vals) * window_s + 3.0, 100.0)]
    t_end = (len(vals) + 2) * window_s
    drains = rng.uniform(size=len(samples)) < 0.5

    def probe(m):
        out = []
        for cadence in (np.zeros_like(drains), drains):
            ring = m.metrics.WindowedRing(window_s=window_s)
            bank = m.detectors.DetectorBank("s", ring, [_DETECTORS[kind](m.detectors)])
            events = []
            for (t, v), drain in zip(samples, cadence):
                ring.observe(t, v)
                if drain:
                    events += bank.drain(t)
            events += bank.drain(t_end)
            out.append((events, vars(bank.detectors[0])))
        assert json.dumps(out[0], default=repr) == json.dumps(out[1], default=repr)
        return out[0]
    both(probe)


def test_ewma_step_settling_matches_jax():
    def probe(m):
        det = m.detectors.EWMAZScore(value="mean", alpha=0.3, z_on=4.0, z_off=1.5,
                                     warmup=5, settle_windows=4)
        vals = [1.0, 1.1, 0.9, 1.05, 0.95, 1.0, 1.02, 0.98] + [5.0] * 40 + [1.0] * 10
        events = [det.update(w, 10.0, (1, v, v, v)) for w, v in enumerate(vals)]
        return [e for e in events if e is not None], det.alerting
    events, alerting = both(probe)
    assert [e["state"] for e in events][:2] == ["fire", "clear"] and not alerting


def test_fleet_percentile_merge_matches_jax():
    def probe(m):
        reg = m.metrics.MetricsRegistry()
        rng = np.random.default_rng(5)
        for i in range(300):
            reg.observe("engine.latency_s", float(rng.lognormal(-3.0, 1.5)),
                        provider=("lambda", "gcf")[i % 2], benchmark=f"b{i % 7}")
        merged = m.report.merge_latency_sketches(reg.snapshot())
        a, b = m.metrics.QuantileSketch(), m.metrics.QuantileSketch()
        for i in range(50):
            (a if i % 2 else b).observe(0.001 * (i + 1) ** 2)
        a.merge(b)
        return merged, a.buckets, [a.quantile(q) for q in (0.5, 0.9, 0.95, 0.99)]
    merged, _, _ = both(probe)
    assert {p: s["count"] for p, s in merged.items()} == {"gcf": 150, "lambda": 150}


# ------------------------------------------------------------ SLO monitor
def test_slo_specs_load_and_round_trip_as_in_jax(tmp_path):
    path = tmp_path / "slos.json"

    def probe(m):
        specs = m.slo.default_slos(window_s=30.0)
        path.write_text(json.dumps([s.to_dict() for s in specs]))
        loaded = m.slo.load_slos(str(path))
        return [s.to_dict() for s in specs], [s.to_dict() for s in loaded]
    specs, loaded = both(probe)
    assert specs == loaded and len(specs) >= 4


def test_slo_monitor_alerts_and_incidents_match_jax():
    """A fleet whose error rate and latency jump mid-run, fed wave by wave,
    plus job events that miss their deadline and burn their budget: the
    alerts, anomalies, incidents, feed and verdict equal JAX's."""
    rng = np.random.default_rng(9)
    waves = []
    for w in range(40):
        bad = 15 <= w < 25
        n = 32
        waves.append((w * 30.0 + np.sort(rng.uniform(0, 30, n)),
                      rng.lognormal(0.0 if not bad else 1.5, 0.2, n),
                      rng.uniform(size=n) < 0.2,
                      rng.uniform(size=n) > (0.3 if bad else 0.01),
                      rng.uniform(size=n) < (0.2 if bad else 0.0)))

    def probe(m):
        obs = m.obs.Observability.monitoring()
        mon = obs.monitor
        feed = mon.engine_feed("lambda")
        for i, (ts, durs, cold, ok, timeout) in enumerate(waves):
            feed.dispatch_wave(ts, durs, cold, ok, timeout)
            if i % 3 == 0:
                mon.job_event("submitted", float(ts[0]), job=f"j{i}", tenant=f"t{i % 2}",
                              deadline_s=60.0, budget_usd=0.01)
                mon.job_event("budget", float(ts[-1]), job=f"j{i}", tenant=f"t{i % 2}",
                              frac=0.35 * (i % 4))
                mon.job_event("delivered", float(ts[-1]) + 90.0, job=f"j{i}",
                              tenant=f"t{i % 2}")
            mon.evaluate(float(ts[-1]))
        chunks, cursor = [], (0, 0)
        for _ in range(3):
            rows, cursor = mon.alert_feed(cursor)
            chunks += rows
        return obs.health(), mon.snapshot(), chunks, m.incidents.render_incidents(
            obs.incidents())
    health, _, feed, text = both(probe)
    assert health["alerts"] or health["anomalies"]
    assert len(feed) == len(health["alerts"]) + len(health["anomalies"])
    assert health["verdict"] in ("warn", "breach") and text


# ------------------------------------------------------------ watch tool
@pytest.mark.parametrize("scenario", ["calm", "timeout_storm", "region_degradation",
                                      "zombie_wave"])
def test_watch_scenario_health_matches_jax(scenario, tmp_path, capsys):
    """``python -m ...obs.watch --scenario S --quick --out H`` on each side:
    the same exit code, printed report and health JSON, byte for byte."""
    gate = ["--expect-clean"] if scenario == "calm" else ["--expect-incident"]

    def probe(m):
        out = tmp_path / f"{m.obs.__name__}.json"
        code = m.watch.main(["--scenario", scenario, "--quick", "--out", str(out)] + gate)
        printed = capsys.readouterr()
        return code, printed.out.replace(str(out), "<out>"), printed.err, out.read_text()
    code, _, _, text = both(probe)
    health = json.loads(text)
    assert health["scenario"]["name"] == scenario
    if scenario == "calm":
        assert code == 0 and health["verdict"] == "healthy" and health["incidents"] == []
    else:
        assert health["ground_truth"] and health["verdict"] in ("warn", "breach")
    if scenario == "timeout_storm":
        assert code == 0 and health["verdict"] == "warn"
        assert len(health["incidents"]) == 1 and health["detection"]["recall"] == 1.0
        json.loads(text, parse_constant=lambda c: pytest.fail(f"non-strict JSON {c}"))


def test_naive_watch_baseline_matches_jax():
    health = both(lambda m: m.watch.run_scenario("timeout_storm", seed=1, quick=True,
                                                 naive=True))
    assert health["scenario"]["naive"] and health["slos"] == []
