"""The port's examples (``python -m repro_torch.examples.<name>``) against
the JAX package's (``examples/<name>.py``).

The continuous-benchmarking example runs in virtual time on the host, so it
must print what JAX's prints, byte for byte.  The model examples are thin
wrappers over the launch entry points: each must hand its entry point JAX's
arguments plus ``--device``, and run on the CPU when asked.
"""
import importlib
import re
import sys

import pytest

from _torch_bench import ROOT
from test_torch_obs import restore_contexts  # noqa: F401 (fixture)

# the benchmarks, the tables and the examples install a process-wide obs
# context and default engine (the service, the replan controller, run.py)
# and never put them back
pytestmark = pytest.mark.usefixtures("restore_contexts")


def _example(side, name):
    pkg = "examples" if side == "jax" else "repro_torch.examples"
    return importlib.import_module(f"{pkg}.{name}")


def test_continuous_benchmarking_prints_what_jax_prints(capsys):
    _example("port", "continuous_benchmarking").main()
    got = capsys.readouterr().out
    _example("jax", "continuous_benchmarking").main()
    assert got == capsys.readouterr().out
    assert "CI GATE: " in got and "<-- the hidden drift" in got


def _captured(monkeypatch, side, entry, name, argv):
    """The argv that ``name``'s ``main`` hands ``entry``'s ``main`` on
    ``side`` (JAX's examples read ``sys.argv``)."""
    launch = importlib.import_module(
        f"{'repro' if side == 'jax' else 'repro_torch'}.launch.{entry}")
    seen = []
    monkeypatch.setattr(launch, "main", lambda a: seen.append(list(a)))
    if side == "jax":
        monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
        _example(side, name).main()
    else:
        _example(side, name).main(argv)
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("name,entry,argv", [
    ("serve_batch", "serve", []),
    ("serve_batch", "serve", ["--arch", "mamba2-1.3b", "--gen", "4"]),
    ("train_lm", "train", ["--ckpt-dir", "build/x"]),
    ("train_lm", "train", ["--size", "100m", "--steps", "3", "--ckpt-dir", "build/x"]),
], ids=["serve-internlm2", "serve-mamba2", "train-tiny", "train-100m"])
def test_model_examples_hand_their_entry_point_jaxs_argv(name, entry, argv, monkeypatch):
    want = _captured(monkeypatch, "jax", entry, name, argv)
    assert _captured(monkeypatch, "port", entry, name, argv + ["--device", "cpu"]) == \
        want + ["--device", "cpu"]


def test_train_lm_checkpoints_under_build_by_default(monkeypatch):
    argv = _captured(monkeypatch, "port", "train", "train_lm", [])
    ckpt = ROOT / argv[argv.index("--ckpt-dir") + 1]
    assert ckpt.parent == ROOT / "build"


def test_serve_batch_serves_on_the_cpu(capsys):
    toks = _example("port", "serve_batch").main(["--device", "cpu", "--gen", "3"])
    assert toks.shape == (4, 3)
    assert [line.split()[0] for line in capsys.readouterr().out.splitlines()] == ["[serve]"] * 3


def test_train_lm_trains_on_the_cpu(tmp_path, capsys):
    res = _example("port", "train_lm").main(["--device", "cpu", "--steps", "3",
                                             "--ckpt-dir", str(tmp_path)])

    assert [s["step"] for s in res.steps] == [0, 1, 2]
    assert (tmp_path / "step_3").is_dir()


def test_quickstart_prints_one_verdict(capsys):
    _example("port", "quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2
    assert re.fullmatch(r"attention_dot_vs_chunked: median diff [+-]\d+\.\d% \(99% CI "
                        r"\[[+-]\d+\.\d%, [+-]\d+\.\d%\]\) over 15 duet pairs -> "
                        r"(PERFORMANCE CHANGE|no change)", out[0]), out[0]
    assert re.fullmatch(r"wall \d+\.\ds, 15 invocations, \d+ retries, \d+ hedged", out[1])
