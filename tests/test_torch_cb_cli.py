"""The port's command line (``python -m repro_torch.cb.cli``) against the JAX
package's (``python -m repro.cb.cli``).

An inline synthetic run is virtual-time and seeded, and both sides run the
same NumPy code, so the port must print the same JSON summary lines and
write the same history file, byte for byte.  The kernel suite runs on the
CPU here (``--device cpu``); the service and observability flags raise in
the port, naming their ROADMAP item.
"""
import json

import pytest

from repro.cb import cli as jax_cli
from repro_torch.cb import cli

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


def test_kernel_suite_wants_the_card_unless_asked_for_the_cpu(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--suite", "kernels", "--n-calls", "3", "--repeats", "1"])


@pytest.mark.parametrize("flags, item", [
    (["--jobs", "2"], "service/"),
    (["--deadline", "900"], "service/"),
    (["--budget", "0.25"], "service/"),
    (["--trace", "t.json"], "the rest of obs/"),
    (["--metrics-out", "m.json"], "the rest of obs/"),
    (["--slo"], "the rest of obs/"),
    (["--health-out", "h.json"], "the rest of obs/"),
])
def test_service_and_obs_flags_name_their_roadmap_item(flags, item, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md §1, {item}"):
        cli.main(["--commits", "2"] + flags)
    assert list(tmp_path.iterdir()) == []


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
