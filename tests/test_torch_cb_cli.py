"""The port's command line (``python -m repro_torch.cb.cli``) against the JAX
package's (``python -m repro.cb.cli``).

An inline synthetic run is virtual-time and seeded, and both sides run the
same NumPy code, so the port must print the same JSON summary lines and
write the same history file, byte for byte; so must a run through the
benchmarking service (``--jobs``, ``--deadline``, ``--budget``) and one
with the observability flags, their trace, metrics and health files
included.  The kernel suite runs on the CPU here (``--device cpu``).
"""
import json

import pytest

from repro import obs as jax_obs
from repro.cb import cli as jax_cli
from repro_torch import obs as port_obs
from repro_torch.cb import cli
from test_torch_obs import restore_contexts  # noqa: F401 (fixture)

SYNTHETIC_RUNS = [
    ["--commits", "3", "--providers", "lambda,gcf", "--mode", "all", "--seed", "1"],
    ["--commits", "20", "--providers", "lambda", "--mode", "selective_cached", "--seed", "0"],
]


def _run(main, argv, tmp_path, capsys):
    """(exit code, stdout lines with the history path masked, history text)."""
    path = tmp_path / "history.jsonl"
    code = main(argv + ["--history", str(path)])
    out = capsys.readouterr().out.replace(str(path), "<history>").splitlines()
    return code, out, path.read_text()


@pytest.mark.parametrize("argv", SYNTHETIC_RUNS, ids=["3-commits-all-modes", "20-commits"])
def test_synthetic_run_prints_and_writes_what_jax_does(argv, tmp_path, capsys):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _run(cli.main, argv, tmp_path / "port", capsys)
    assert got == _run(jax_cli.main, argv, tmp_path / "jax", capsys)
    code, out, history = got
    summaries = [json.loads(line) for line in out if line.startswith("{")]
    modes = 3 if "all" in argv else 1
    providers = argv[argv.index("--providers") + 1].split(",")
    assert code == 0 and len(summaries) == modes * len(providers)
    assert all(s["suite"] == "synthetic" and s["commits"] == int(argv[1]) - 1
               and s["invocations"] > 0 for s in summaries)
    assert out[-1].startswith("history: ") and history.count("\n") == int(
        out[-1].split()[1])


def test_kernel_suite_on_the_cpu_gives_one_summary(tmp_path, capsys):
    code, out, history = _run(cli.main, ["--suite", "kernels", "--device", "cpu",
                                         "--n-calls", "3", "--repeats", "1"], tmp_path, capsys)
    summaries = [json.loads(line) for line in out if line.startswith("{")]
    assert code == 0 and len(summaries) == 1
    s = summaries[0]
    assert (s["suite"], s["provider"], s["mode"], s["commits"]) == \
        ("kernels", "local", "selective_cached", 1)
    assert s["invocations"] == 9 and s["cost_usd"] == 0.0
    records = [json.loads(line) for line in history.splitlines()]
    runs = sorted(r["benchmark"] for r in records if r["source"] == "run")
    assert runs == ["attention_dot_vs_chunked", "rmsnorm_fused_vs_unfused",
                    "ssd_recurrence_vs_chunked"]
    assert all(r["invocations"] == 3 for r in records if r["source"] == "run")


def test_observed_kernel_suite_records_what_jax_records(tmp_path, monkeypatch, capsys,
                                                        restore_contexts):  # noqa: F811
    """The kernel suite under the four observability flags, as the JAX
    command line records it: one commit span (its length is the run's host
    time), the commit and selection counters, and a health verdict."""
    monkeypatch.chdir(tmp_path)
    code = cli.main(["--suite", "kernels", "--device", "cpu", "--n-calls", "3", "--repeats",
                     "1", "--parallelism", "1", "--trace", "t.json", "--metrics-out",
                     "m.json", "--slo", "--health-out", "h.json"])
    err = capsys.readouterr().err
    trace = json.loads((tmp_path / "t.json").read_text())
    assert port_obs.validate_chrome_trace(trace) == []
    spans = [e for e in trace["traceEvents"] if e["ph"] != "M"]
    assert [(e["ph"], e["cat"], e["name"]) for e in spans] == [("X", "commit", "head")]
    assert spans[0]["dur"] > 0
    counters = json.loads((tmp_path / "m.json").read_text())["counters"]
    assert {c["name"]: (c["labels"], c["value"]) for c in counters} == {
        "cb.commits": ({"provider": "local"}, 1.0),
        "cb.benchmarks_selected": ({"provider": "local"}, 3.0)}
    health = json.loads((tmp_path / "h.json").read_text())
    assert health["verdict"] in ("healthy", "warn", "breach")
    assert code == (cli.EXIT_BREACH if health["verdict"] == "breach" else 0)
    assert f"slo verdict: {health['verdict']}" in err


def test_kernel_suite_wants_the_card_unless_asked_for_the_cpu(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--suite", "kernels", "--n-calls", "3", "--repeats", "1"])


@pytest.mark.parametrize("flags", [
    ["--jobs", "2"],
    ["--deadline", "900"],
    ["--budget", "0.25"],
    ["--trace", "t.json"],
    ["--metrics-out", "m.json"],
    ["--slo"],
    ["--health-out", "h.json"],
    ["--trace", "t.json", "--health-out", "h.json"],
    ["--slo", "--trace", "t.json", "--metrics-out", "m.json", "--health-out", "h.json"],
    ["--jobs", "2", "--slo", "--health-out", "h.json"],
], ids=["jobs", "deadline", "budget", "trace", "metrics-out", "slo", "health-out-alone",
        "health-out-without-slo", "all-obs-flags", "jobs-with-slo"])
def test_service_and_obs_flags_do_what_jax_does(flags, tmp_path, monkeypatch, capsys,
                                                restore_contexts):  # noqa: F811
    """The service and observability flags on a short synthetic stream: the
    exit code, the printed lines and every file written (history, trace,
    metrics, health verdict) equal the JAX command line's.  ``--health-out``
    writes only under ``--slo``, as in JAX."""
    def run(main, obs, side):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        code = main(["--commits", "2", "--n-calls", "6", "--seed", "2",
                     "--history", "history.jsonl"] + flags)
        obs.set_obs(None)
        cap = capsys.readouterr()
        files = {p.name: p.read_text() for p in sorted((tmp_path / side).iterdir())}
        return code, cap.out.splitlines(), cap.err.splitlines(), files
    got = run(cli.main, port_obs, "port")
    assert got == run(jax_cli.main, jax_obs, "jax")
    code, out, err, files = got
    assert code in (0, cli.EXIT_BREACH) and json.loads(out[0])["invocations"] > 0
    written = {f for f in ("t.json", "m.json", "h.json") if f in flags}
    if "--slo" not in flags:
        written.discard("h.json")
    assert set(files) == {"history.jsonl"} | written
    service = any(f in flags for f in ("--jobs", "--deadline", "--budget"))
    assert service == json.loads(out[0]).get("service", False)
    if "--slo" in flags:
        assert any(line.startswith("slo verdict: ") for line in err)


def test_kernel_suite_in_service_mode_is_refused_as_in_jax(capsys, restore_contexts):  # noqa: F811
    argv = ["--suite", "kernels", "--jobs", "2"]
    got = cli.main(argv), capsys.readouterr()
    ref = jax_cli.main(argv), capsys.readouterr()
    assert got == ref and got[0] == cli.EXIT_INFEASIBLE
    assert "service mode needs a simulated suite" in got[1].err


@pytest.mark.parametrize("codes", [
    (cli.EXIT_INFEASIBLE, cli.EXIT_FALLBACK), (cli.EXIT_FALLBACK, cli.EXIT_INFEASIBLE),
    (cli.EXIT_INFEASIBLE, cli.EXIT_BREACH), (cli.EXIT_BREACH, cli.EXIT_INFEASIBLE),
    (cli.EXIT_FALLBACK, cli.EXIT_BREACH), (cli.EXIT_BREACH, cli.EXIT_FALLBACK),
    (0, cli.EXIT_INFEASIBLE, 0, cli.EXIT_FALLBACK),
    (cli.EXIT_BREACH, cli.EXIT_FALLBACK, cli.EXIT_INFEASIBLE),
    (), (0, 0), (0, cli.EXIT_BREACH), (0, 7), (7, cli.EXIT_BREACH),
])
def test_resolve_exit_code_matches_jax(codes):
    assert cli.EXIT_PRECEDENCE == jax_cli.EXIT_PRECEDENCE == (2, 3, 4)
    assert cli.resolve_exit_code(*codes) == jax_cli.resolve_exit_code(*codes)
