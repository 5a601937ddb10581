"""A cut-down checkout for the CPU tests: the benchmark's own metric
readers, families and references, and configuration, traffic and limit
files at a tiny size, with a BENCHMARK.json that names them."""
import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "tiny-dense": ("internlm2-1.8b", dict(num_hidden_layers=2, hidden_size=128,
                                          num_attention_heads=4, num_key_value_heads=2,
                                          head_dim=32, intermediate_size=256, vocab_size=300)),
    "tiny-ssm": ("mamba2-1.3b", dict(num_hidden_layers=2, hidden_size=128, state_size=16,
                                     head_dim=16, chunk_size=16, vocab_size=300)),
}
MIX = {"batch": 2, "entries": [{"prompt": 40, "output": 6}, {"prompt": 24, "output": 8}],
       "check_requests": 3}
# a bf16 program at this size reads gaps of 0 to a few hundredths
LIMIT = 0.1


def tiny_config(name):
    base, cut = TINY[name]
    cfg = json.loads((BENCH / "configs" / f"{base}.json").read_text())
    cfg.update(cut, name=name)
    return cfg


def make_root(root: Path):
    bench = root / BENCH.name
    for sub in ("metrics", "families", "reference"):
        shutil.copytree(BENCH / sub, bench / sub, ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    (bench / "traffic" / "tinymix.json").write_text(json.dumps(MIX))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"], spec["workloads"] = [], []
    for name in TINY:
        (bench / "configs" / f"{name}.json").write_text(json.dumps(tiny_config(name)))
        spec["configs"].append({"name": name, "source": "tiny", "reduced": [], "why": "test",
                                "file": f"{BENCH.name}/configs/{name}.json"})
        cell = f"{name}.tinymix"
        spec["workloads"].append({"name": cell, "config": name, "traffic": "tinymix",
                                  "chips": 1, "why": "test"})
        (bench / "limits" / f"{cell}.json").write_text(json.dumps({"max_gap": {"limit": LIMIT}}))
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root

