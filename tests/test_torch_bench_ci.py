"""The port's benchmark scripts (``repro_torch.benchmarks.{chaos,obs,service,
replan,engine}_bench``) against the JAX package's (``benchmarks/*_bench.py``).

Every script's output is virtual time over the same NumPy code on both
sides, except the host-clock fields of ``tests/_torch_bench.py::HOST_FIELDS``,
so the rest must be equal exactly, and each gate over the committed
``BENCH_*.json`` baselines must give JAX's verdict.  Where a gate reads a
host field (the engine and service-scaling speedups), both packages' gates
are given the same point, the port's.
"""
import json

import pytest

from _torch_bench import ROOT, as_json, bench, drop_host_fields
from test_torch_obs import restore_contexts  # noqa: F401 (fixture)

# the benchmarks, the tables and the examples install a process-wide obs
# context and default engine (the service, the replan controller, run.py)
# and never put them back
pytestmark = pytest.mark.usefixtures("restore_contexts")

SIDES = ("port", "jax")


def _each(name, fn):
    """``fn(module)`` on the port's module and on JAX's."""
    return {side: fn(bench(side, name)) for side in SIDES}


def _equal(points, output):
    got, want = (drop_host_fields(points[s], output) for s in SIDES)
    assert as_json(got) == as_json(want)
    return got


def test_chaos_bench_point_and_gates_equal_jax():
    points = _each("chaos_bench", lambda m: m.run(True, 0))
    point = _equal(points, "chaos_bench")
    assert point["name"] == "chaos_robustness" and point["quick"] is True
    base = str(ROOT / "BENCH_chaos.json")
    verdicts = {side: (bench(side, "chaos_bench").check(points[side]),
                       bench(side, "chaos_bench").check_baseline(points[side], base))
                for side in SIDES}
    assert verdicts["port"] == verdicts["jax"] == ([], [])


def test_obs_bench_point_and_gates_equal_jax():
    points = _each("obs_bench", lambda m: m.run(True, 0))
    point = _equal(points, "obs_bench")
    assert point["name"] == "slo_detection"
    base = str(ROOT / "BENCH_obs.json")
    verdicts = {side: (bench(side, "obs_bench").check(points[side]),
                       bench(side, "obs_bench").check_baseline(points[side], base))
                for side in SIDES}
    assert verdicts["port"] == verdicts["jax"] == ([], [])


def _gate(fn, capsys):
    rc = fn()
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_service_bench_profile_and_gate_equal_jax(capsys):
    points = _each("service_bench", lambda m: m.run_profile(8, 34))
    profile = _equal(points, "service_bench.run_profile")
    assert sorted(profile) == ["azure", "gcf", "lambda"]
    base = str(ROOT / "BENCH_service.json")
    gates = {side: _gate(lambda: bench(side, "service_bench").check_baseline(
        points[side], base), capsys) for side in SIDES}
    assert gates["port"] == gates["jax"] and gates["port"][0] == 0


def test_service_bench_scaling_row_equals_jax(capsys):
    rows = _each("service_bench", lambda m: m.run_scaling("small", 34))
    got = _equal(rows, "service_bench.run_scaling")
    assert len(got) == 1 and got[0]["digests_equal"] is True
    committed = json.loads((ROOT / "BENCH_service.json").read_text())["service_scaling"][0]
    assert got[0]["digest"] == committed["digest"]
    base = str(ROOT / "BENCH_service.json")
    verdicts = {side: bench(side, "service_bench").check_scaling(rows["port"], base)
                for side in SIDES}
    assert verdicts["port"] == verdicts["jax"]


def test_replan_bench_document_and_gate_equal_jax(capsys):
    docs = _each("replan_bench", lambda m: m.run_replan_experiment(quick=True))
    doc = _equal(docs, "replan_bench")
    assert [r["scenario"] for r in doc["replan_vs_static"]] == ["zero", "moderate", "heavy"]
    base = str(ROOT / "BENCH_replan.json")
    gates = {side: _gate(lambda: bench(side, "replan_bench").check_baseline(
        docs[side], base), capsys) for side in SIDES}
    assert gates["port"] == gates["jax"] and gates["port"][0] == 0


def test_replan_bench_writes_its_incident_artifacts(tmp_path, capsys):
    out = tmp_path / "replan.json"
    rc = bench("port", "replan_bench").main(
        ["--quick", "--out", str(out), "--incidents-out", str(tmp_path / "inc")])
    doc = json.loads(out.read_text())
    assert rc == 0 and doc["quick"] is True
    for name in ("incidents", "renegotiations"):
        assert json.loads((tmp_path / "inc" / f"{name}.json").read_text()) == \
            doc["artifacts"][name]


def test_engine_bench_digests_equal_jax(capsys):
    rows = _each("engine_bench", lambda m: m.run_profile(True, 0))
    capsys.readouterr()                    # the profile's host-timed lines
    got = _equal(rows, "engine_bench")
    assert [r["n_invocations"] for r in got] == [1000, 10000]
    assert all(r["conformant"] is True and len(r["digest"]) == 16 for r in got)
    base = str(ROOT / "BENCH_engine.json")
    gates = {side: _gate(lambda: bench(side, "engine_bench").check_baseline(
        rows["port"], base), capsys) for side in SIDES}
    assert gates["port"] == gates["jax"]


@pytest.mark.parametrize("name,argv", [
    ("chaos_bench", ["--quick", "--check"]),
    ("obs_bench", ["--quick", "--check"]),
])
def test_ci_lines_exit_0_and_write_under_out(name, argv, tmp_path, capsys):
    out = tmp_path / "sub" / f"{name}.json"
    assert bench("port", name).main(argv + ["--out", str(out)]) == 0
    assert json.loads(out.read_text())["quick"] is True
