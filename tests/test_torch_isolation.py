"""The port stands alone: no jax, nothing of ``repro``; no silent CPU fallback."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

SRC = Path(__file__).resolve().parents[1] / "src"


def _modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert {"repro_torch.launch.serve", "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.ssd_scan", "repro_torch.models.ssm",
            "repro_torch.models.lm", "repro_torch.models.convert"} <= set(mods)
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"          # any import of them now raises
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(" + repr(mods) + "))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_serve_without_device_flag_wants_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--reduced", "--batch", "1", "--prompt-len", "4", "--gen", "2"])


def test_serve_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    toks = serve.main(["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                       "--gen", "3"])
    assert toks.shape == (2, 3) and toks.min() >= 0 and toks.max() < 256
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in out] == ["[serve]"] * 3


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b",
                                  "whisper-medium", "llava-next-34b", "jamba-1.5-large-398b"])
def test_unported_families_name_their_roadmap_item(arch):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        LM(get_config(arch).reduced(), device="cpu")

