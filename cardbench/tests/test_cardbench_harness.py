"""The harness end to end on the CPU at a tiny size: a whole run of a cell
(the look for a card skipped), the output check failing under each fault
that a served cell can have, a cell made only of new files, the refusals
and the module isolation."""
import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from cardbench import faults, harness, trace
from cardbench.tests.tiny import BENCH, REPO, make_root

CELLS = ["tiny-dense.tinymix", "tiny-ssm.tinymix"]
SEED = 2**31 + 77      # more than 32 signed bits hold


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


def run(root, cell, trace_on=False, seed=SEED):
    return harness.run_cell(root, cell, seed, 0.0, trace_on, device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_root, cell):
    r = run(tiny_root, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 4 and r["failed"] == 0      # one cycle: 2 batches of 2
    assert set(r["metrics"]) == {"ttft_ms_p95", "tokens_per_s.host_bound", "setup_s"}
    assert list(r)[-1] == "checks"
    assert r["checks"]["max_gap"]["value"] <= r["checks"]["max_gap"]["limit"]


def test_the_same_seed_serves_the_same_tokens(tiny_root):
    a = harness.load_cell(tiny_root, CELLS[0])[2].cycle(SEED, 0, 0)
    b = harness.load_cell(tiny_root, CELLS[0])[2].cycle(SEED, 0, 0)
    assert a == b
    mix = harness.load_cell(tiny_root, CELLS[0])[2]
    p1 = mix.prompts(SEED, a[0], 300, "cpu")
    p2 = mix.prompts(SEED, a[0], 300, "cpu")
    assert torch.equal(p1, p2)
    # another seed: the same sizes in some order
    other = mix.cycle(SEED + 1, 0, 0)
    assert sorted((x.prompt, x.output) for x in other) == sorted((x.prompt, x.output) for x in a)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(tiny_root, cell, fault):
    cfg = harness.load_cell(tiny_root, cell)[1]
    with faults.FAULTS[fault](cfg):
        r = run(tiny_root, cell)
    assert not r["correct"]
    assert r["checks"]["max_gap"]["value"] > r["checks"]["max_gap"]["limit"]


def test_a_cell_from_new_files_alone(tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as files of
    their own and entries of BENCHMARK.json, with no code of the harness
    edited."""
    root = make_root(tmp_path)
    bench = root / BENCH.name
    cfg = json.loads((bench / "configs" / "tiny-dense.json").read_text())
    cfg.update(name="tiny-wide", intermediate_size=384)
    (bench / "configs" / "tiny-wide.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "burst.json").write_text(json.dumps(
        {"batch": 3, "entries": [{"prompt": 8, "output": 2}], "check_requests": 2}))
    (bench / "metrics" / "served_tokens.py").write_text(
        "def read(run):\n"
        "    return float(sum(r.tokens.size for r in run.records))\n")
    (bench / "limits" / "tiny-wide.burst.json").write_text(json.dumps({"max_gap": {"limit": 0.1}}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-wide", "source": "tiny", "reduced": [], "why": "test",
                            "file": f"{BENCH.name}/configs/tiny-wide.json"})
    spec["workloads"].append({"name": "tiny-wide.burst", "config": "tiny-wide",
                              "traffic": "burst", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "served_tokens", "unit": "tokens", "better": "higher",
                               "bound": 0.01, "source": "host_clock",
                               "workloads": ["tiny-wide.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = run(root, "tiny-wide.burst")
    assert r["correct"]
    assert r["metrics"]["served_tokens"]["value"] == 3 * 2
    assert "served_tokens" not in run(root, CELLS[0])["metrics"]


@pytest.mark.parametrize("sub", ["families", "reference"])
def test_a_family_without_its_file_is_refused(tiny_root, sub):
    """A cell whose family lacks its module or its reference is refused,
    naming the file; a cell of another family still runs."""
    (tiny_root / BENCH.name / sub / "ssm.py").unlink()
    with pytest.raises(harness.Refused, match=f"{BENCH.name}/{sub}/ssm.py") as e:
        run(tiny_root, "tiny-ssm.tinymix")
    assert e.value.code != 0
    assert run(tiny_root, "tiny-dense.tinymix")["correct"]


def test_a_traced_run_reports_the_layers_metrics(tiny_root):
    r = run(tiny_root, CELLS[0], trace_on=True)
    assert "busy_s" in r["device"] and "window_s" in r["device"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU no device operation runs: the device metrics read nothing
    assert "decode.device_ms.host_bound" not in r["metrics"]
    assert "decode.device_ms.unbounded" not in r["metrics"]
    # a twin of an unbounded cell reads what its original reads
    m = r["metrics"]
    assert m["decode.host_ms.unbounded"]["value"] == m["decode.host_ms"]["value"]
    assert m["tokens_per_s.unbounded"]["value"] > 0


def test_trace_ranges_take_the_device_time_inside_them():
    """A kernel belongs to the range that holds its midpoint; idle time goes
    to the innermost range the host was in."""
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU

    def ev(name, dev, start, dur):
        return SimpleNamespace(name=lambda: name, device_type=lambda: dev,
                               start_ns=lambda: start, duration_ns=lambda: dur,
                               is_user_annotation=lambda: name.startswith("cb."))
    t = trace.Tracer(torch, on_card=False)
    t.open = {"cb.prefill#0": trace.Range("prefill", {}), "cb.k1#1": trace.Range("k1", {})}
    events = [ev("cb.prefill#0", cpu, 0, 1000), ev("cb.k1#1", cpu, 200, 400),
              ev("gemm", cuda, 10, 150), ev("k1_kernel", cuda, 250, 300),
              ev("cb.k1#1", cuda, 250, 300), ev("tail", cuda, 700, 200)]
    t._read(events, period_s=1200e-9)
    pre, k1 = t.data.of("prefill")[0], t.data.of("k1")[0]
    assert pre.device_s == pytest.approx(650e-9) and k1.device_s == pytest.approx(300e-9)
    assert k1.idle_s == pytest.approx(100e-9) and pre.idle_s == pytest.approx(350e-9)
    assert t.data.busy_s == pytest.approx(650e-9)
    assert t.data.idle == pytest.approx({"prefill": 250e-9, "k1": 100e-9, "outside": 200e-9})
    assert t.data.ops == pytest.approx({"gemm": 150e-9, "k1_kernel": 300e-9, "tail": 200e-9})


def _main(root, *argv):
    """run.py's main in a subprocess, from a checkout at ``root``."""
    script = (f"import sys; sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]\n"
              "import cardbench.harness as h\n"
              f"sys.exit(h.main({list(argv)!r}, root={str(root)!r}))\n")
    return subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    p = _main(REPO, "--workload", "internlm2-1.8b.longdoc", "--seed", "1", "--seconds", "1")
    assert p.returncode == 2 and p.stdout.strip() == "", p.stderr
    assert "no CUDA card" in p.stderr


def test_a_checkout_without_the_program_has_no_result(tmp_path):
    root = make_root(tmp_path)
    p = _main(root, "--workload", CELLS[0], "--seed", "1", "--seconds", "1")
    assert p.returncode != 0 and p.stdout.strip() == "", p.stderr


def test_no_module_of_jax_or_the_jax_package_is_loaded(tmp_path):
    """A whole run of each tiny cell and both references, then the top-level
    names of every module loaded, compared whole (the port's name begins
    with the JAX package's)."""
    root = make_root(tmp_path)
    script = (f"import sys; sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]\n"
              "import pathlib, json\n"
              "from cardbench import harness\n"
              "import cardbench.calibrate, cardbench.reference.dense, cardbench.reference.ssm\n"
              f"for cell in {CELLS!r}:\n"
              f"    harness.run_cell(pathlib.Path({str(root)!r}), cell, 5, 0.0, True, device='cpu')\n"
              "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "cardbench" in tops
    assert not tops & set(harness.FORBIDDEN)
