"""The port's statistics-engine harness (``repro_torch.benchmarks.perf_bench``)
against the JAX package's (``benchmarks/perf_bench.py``).

The JAX script's pipeline scenario cannot run: it swaps the adaptive
controller's analyzer for its seed replica, which does not take the
``robust`` argument that the controller passes (``TypeError``).  The port's
replica takes it, so the scenario runs and its batched and seed runs are
held to each other.  Times and speedups are host numbers
(``tests/_torch_bench.py::HOST_FIELDS``).
"""
import json

import pytest

from _torch_bench import as_json, bench, drop_host_fields
from test_torch_obs import restore_contexts  # noqa: F401 (fixture)

# the benchmarks, the tables and the examples install a process-wide obs
# context and default engine (the service, the replan controller, run.py)
# and never put them back
pytestmark = pytest.mark.usefixtures("restore_contexts")

PERF = {side: bench(side, "perf_bench") for side in ("jax", "port")}


def test_the_pipeline_scenario_runs_through_the_seed_analyzer(monkeypatch):
    """bench_pipeline asserts that its batched and seed runs flag the same
    commits and events at the same invocation count; the seed analyzer it
    patches into the controller must really have run."""
    calls = {"init": 0, "result": 0}
    legacy = PERF["port"].LegacyStreamingAnalyzer

    class Counted(legacy):
        def __init__(self, **kw):
            calls["init"] += 1
            super().__init__(**kw)

        def result(self, benchmark):
            calls["result"] += 1
            return super().result(benchmark)

    monkeypatch.setattr(PERF["port"], "LegacyStreamingAnalyzer", Counted)
    res = PERF["port"].bench_pipeline(6, 8, 1)
    assert drop_host_fields(res, "perf_bench") == {
        "commits": 6, "n_calls": 8, "adaptive": True, "benchmarks": 106}
    assert res["legacy_s"] > 0 and res["batched_s"] > 0
    assert calls["init"] > 0 and calls["result"] > 0
    # the patch was undone: the controller builds its own analyzer again
    from repro_torch.core import controller, results
    assert controller.StreamingAnalyzer is results.StreamingAnalyzer


def test_the_jax_scripts_pipeline_scenario_raises_at_the_same_arguments():
    with pytest.raises(TypeError, match="unexpected keyword argument 'robust'"):
        PERF["jax"].bench_pipeline(6, 8, 1)
    from repro.core import controller, results
    assert controller.StreamingAnalyzer is results.StreamingAnalyzer


def test_the_seed_analyzer_has_no_robust_ci():
    legacy = PERF["port"].LegacyStreamingAnalyzer
    assert legacy(robust="none").analyze() == {}
    for robust in ("trim", "winsor"):
        with pytest.raises(ValueError, match="no robust CI"):
            legacy(robust=robust)


@pytest.mark.parametrize("scenario,args", [("bench_analyze", (30, 60, 1)),
                                           ("bench_streaming", (12, 40, 5, 1))])
def test_analysis_scenarios_equal_jax(scenario, args):
    got, want = (drop_host_fields(getattr(PERF[s], scenario)(*args), "perf_bench")
                 for s in ("port", "jax"))
    assert as_json(got) == as_json(want) and got["k"] == args[0]


def test_quick_profile_exits_0_and_writes_its_point(tmp_path, capsys):
    out = tmp_path / "bench" / "BENCH_stats.json"
    assert PERF["port"].main(["--quick", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert sorted(doc["profiles"]["quick"]) == ["analyze", "pipeline", "streaming"]
    assert f"wrote {out}" in capsys.readouterr().out
