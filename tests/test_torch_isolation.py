"""The port stands alone: no jax, nothing of ``repro``, no ``ml_dtypes``; no
silent CPU fallback."""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes",
             "benchmarks", "examples")        # the JAX package's benchmarks/ and examples/
TWINS = ("engine_bench", "paper_tables", "roofline_table", "run", "chaos_bench",
         "obs_bench", "service_bench", "replan_bench", "perf_bench")
EXAMPLES = ("continuous_benchmarking", "quickstart", "serve_batch", "train_lm")


def _modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert {"repro_torch.launch.serve", "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.ssd_scan", "repro_torch.models.ssm",
            "repro_torch.models.lm", "repro_torch.models.convert",
            "repro_torch.core.duet", "repro_torch.core.rmit",
            "repro_torch.core.costmodel", "repro_torch.core.stats",
            "repro_torch.core.results", "repro_torch.core.controller",
            "repro_torch.faas.engine", "repro_torch.faas.backends",
            "repro_torch.faas.platform", "repro_torch.faas.engine_vec",
            "repro_torch.obs", "repro_torch.cb.commits", "repro_torch.cb.select",
            "repro_torch.cb.cache", "repro_torch.cb.history", "repro_torch.cb.detect",
            "repro_torch.cb.registry", "repro_torch.cb.pipeline",
            "repro_torch.benchmarks.kernel_bench", "repro_torch.faas.traces",
            "repro_torch.faas.chaos", "repro_torch.core.experiment",
            "repro_torch.core.autotune", "repro_torch.cb.cli",
            "repro_torch.kernels.stats_boot", "repro_torch.models.moe",
            "repro_torch.train.optimizer", "repro_torch.train.quantized_state",
            "repro_torch.train.data", "repro_torch.train.checkpoint",
            "repro_torch.train.train_step", "repro_torch.launch.train"} <= set(mods)
    assert {f"repro_torch.benchmarks.{m}" for m in TWINS} <= set(mods)
    assert {f"repro_torch.examples.{m}" for m in EXAMPLES} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"          # any import of them now raises
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(" + repr(mods) + "))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _forbidden_imports(path):
    """(line, module) of every import of a ``FORBIDDEN`` package (jax, jaxlib,
    repro, ml_dtypes, and the JAX package's top-level ``benchmarks`` and
    ``examples``) in ``path``, at any depth (inside functions too), and of
    every ``import_module`` or ``__import__`` call on a constant naming one
    of them."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            fn = node.func
            called = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if called in ("import_module", "__import__"):
                names = [node.args[0].value]
        found += [(node.lineno, n) for n in names if n.split(".")[0] in FORBIDDEN]
    return sorted(found)


def test_no_source_of_the_port_imports_jax_or_repro_at_any_depth():
    # and the tests that run on the card, with their helper: a machine with
    # a card and no jax runs them
    tests = ROOT / "tests"
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [tests / "_torch_card.py"] + sorted(
        f for f in tests.glob("test_torch_*.py") if "@pytest.mark.cuda" in f.read_text())
    assert len(files) > 40
    bad = {str(f.relative_to(ROOT)): hits for f in files if (hits := _forbidden_imports(f))}
    assert not bad, bad


def test_the_import_scan_sees_lazy_imports(tmp_path):
    src = tmp_path / "lazy.py"
    src.write_text("import repro_torch.cb\n"
                   "def f():\n"
                   "    from repro.obs import get_obs\n"
                   "    import jax.numpy as jnp\n"
                   "    return importlib.import_module('repro.core.stats')\n"
                   "class C:\n"
                   "    def g(self):\n"
                   "        from jaxlib import xla_client\n"
                   "        from . import sibling\n")
    assert _forbidden_imports(src) == [(3, "repro.obs"), (4, "jax.numpy"),
                                       (5, "repro.core.stats"), (8, "jaxlib")]


def test_the_import_scan_sees_the_jax_benchmarks_and_examples(tmp_path):
    src = tmp_path / "twin.py"
    src.write_text("from repro_torch.benchmarks import paper_tables\n"
                   "def f():\n"
                   "    import benchmarks.paper_tables as pt\n"
                   "    from examples import quickstart\n"
                   "    return importlib.import_module('benchmarks.kernel_bench')\n")
    assert _forbidden_imports(src) == [(3, "benchmarks.paper_tables"), (4, "examples"),
                                       (5, "benchmarks.kernel_bench")]


def test_kernel_suite_without_device_wants_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    from repro_torch.cb import get_suite
    from repro_torch.benchmarks.kernel_bench import KernelSuite
    with pytest.raises(RuntimeError, match="cuda"):
        KernelSuite()
    with pytest.raises(RuntimeError, match="cuda"):
        get_suite("kernels", small=True)


def test_serve_without_device_flag_wants_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--reduced", "--batch", "1", "--prompt-len", "4", "--gen", "2"])


def test_train_without_device_flag_wants_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--reduced", "--steps", "1"])


def test_serve_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    toks = serve.main(["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                       "--gen", "3"])
    assert toks.shape == (2, 3) and toks.min() >= 0 and toks.max() < 256
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in out] == ["[serve]"] * 3


def _arch_ids():
    from repro_torch.configs.all_configs import ARCH_IDS
    return ARCH_IDS


@pytest.mark.parametrize("arch", _arch_ids())
def test_every_arch_builds_on_cpu(arch):
    """Every architecture builds on the CPU when asked, and its reduced
    model's prefill gives finite logits of the padded vocab."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    cfg = get_config(arch).reduced()
    lm = LM(cfg, device="cpu")
    assert lm.device.type == "cpu" and all(p.device.type == "cpu" for p in lm.parameters())
    kw = {}
    if cfg.encoder is not None:
        kw["enc_embeds"] = torch.zeros((1, cfg.encoder.source_len, cfg.d_model))
    if cfg.num_image_tokens:
        kw["embeds_prefix"] = torch.zeros((1, cfg.num_image_tokens, cfg.d_model))
    with torch.no_grad():
        logits = lm.forward(torch.zeros((1, 4), dtype=torch.long), mode="prefill", **kw)["logits"]
    assert logits.shape == (1, 1, lm.plan.V)
    assert torch.isfinite(logits[..., :cfg.vocab_size].float()).all()



def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")


@pytest.mark.parametrize("argv", [[], ["--tables", "kernel_duets"]], ids=["all", "duets"])
def test_benchmark_run_without_device_flag_wants_cuda(argv, capsys):
    """The kernel duets want the card: the harness raises before any table
    runs, instead of printing a -1 row for them."""
    _no_card()
    from repro_torch.benchmarks import run
    with pytest.raises(RuntimeError, match="cuda"):
        run.main(argv)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []),
    ("serve_batch", ["--gen", "2"]),
    ("train_lm", ["--steps", "1"]),
])
def test_model_examples_without_device_flag_want_cuda(name, argv, tmp_path):
    _no_card()
    import importlib
    example = importlib.import_module(f"repro_torch.examples.{name}")
    if name == "train_lm":
        argv = argv + ["--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="cuda"):
        example.main(argv)


def _path_defaults(path):
    """{flag: default} of every ``add_argument`` of a file-path flag in
    ``path`` (``--out``, ``--ckpt-dir``, ``--incidents-out`` ...)."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
                and node.args and isinstance(node.args[0], ast.Constant)
                and node.args[0].value in ("--out", "--ckpt-dir", "--incidents-out",
                                           "--history", "--roofline")):
            default = [k.value for k in node.keywords if k.arg == "default"]
            out[node.args[0].value] = default[0].value if default else None
    return out


def test_no_twins_default_output_is_a_tracked_file():
    """The twins write under build/ (ignored by git) unless told otherwise:
    the BENCH_*.json at the root are the JAX package's committed baselines."""
    files = [SRC / "repro_torch" / "benchmarks" / f"{m}.py" for m in TWINS] + \
        [SRC / "repro_torch" / "examples" / f"{m}.py" for m in EXAMPLES]
    defaults = {f"{f.stem}{flag}": d for f in files for flag, d in _path_defaults(f).items()}
    assert {"service_bench--out", "replan_bench--out", "perf_bench--out", "train_lm--ckpt-dir",
            "chaos_bench--out", "obs_bench--out", "engine_bench--out"} <= set(defaults)
    written = {k: d for k, d in defaults.items() if d is not None and not k.endswith("--roofline")}
    assert all(d.startswith("build/") for d in written.values()), written
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    if (ROOT / ".git").exists():
        tracked = subprocess.run(["git", "ls-files", "--", *written.values()], cwd=ROOT,
                                 capture_output=True, text=True, timeout=60)
        assert tracked.returncode == 0 and tracked.stdout == ""
