"""The port's benchmark harness (``python -m repro_torch.benchmarks.run``)
against the JAX package's (``python -m benchmarks.run``).

The simulated tables, the multi-tenant service summary, the exit codes and
the roofline summary are host-only and seeded, so the port must print what
JAX prints, line for line, with the harness's host column and seconds
masked (``tests/_torch_bench.py``).  The kernel duets time real calls: on
the CPU here (``--device cpu``) their structure is held, not their values.
"""
import json
import math

import pytest

from _torch_bench import bench, mask_run_output
from test_torch_obs import MODS, restore_contexts  # noqa: F401 (fixture)

# the benchmarks, the tables and the examples install a process-wide obs
# context and default engine (the service, the replan controller, run.py)
# and never put them back
pytestmark = pytest.mark.usefixtures("restore_contexts")

RUN = {side: bench(side, "run") for side in ("jax", "port")}


def _main(side, argv, capsys):
    """(exit code, masked stdout lines, stderr) of one side's ``main``."""
    try:
        RUN[side].main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr()
    return code, mask_run_output(out.out), out.err


def _both(argv, capsys):
    got = _main("port", argv, capsys)
    assert got == _main("jax", argv, capsys)
    return got


# ``--tables`` selects by function name (``table_time_cost`` is "time_cost")
# while each row carries the table's own name ("time_cost_headline"); an
# unknown name selects nothing, in both packages
@pytest.mark.parametrize("tables,printed", [
    ("aa,time_cost", ["aa", "time_cost_headline"]),
    ("aa,time_cost_headline", ["aa"]),
])
def test_skip_real_tables_print_what_jax_prints(tables, printed, capsys):
    code, out, _ = _both(["--skip-real", "--tables", tables], capsys)
    rows = [line for line in out if ",<us>," in line]
    assert code == 0 and [r.split(",")[0] for r in rows] == printed
    if "time_cost_headline" in printed:
        headline = json.loads(rows[1].split(",", 2)[2])
        assert headline["faas_wall_min"] <= 15.0 and headline["detection_agreement_pct"] > 90


def test_jobs_summary_is_jaxs(capsys):
    code, out, _ = _both(["--jobs", "2", "--seed", "3"], capsys)
    summary = json.loads(out[0])
    assert code == 0 and len(out) == 1 and summary["n_tenants"] == 2 and summary["jobs"] > 0


def _force_fallback(monkeypatch):
    for mods in MODS.values():
        monkeypatch.setattr(mods.engine_vec, "get_fallback_log",
                            lambda: ["injected: test fallback"])


@pytest.mark.parametrize("flags,fallback,want", [
    ([], False, 0),            # the vectorised core held: no gate fires
    ([], True, 3),             # strict fast degraded to the scalar loop
    (["--slo"], False, 4),     # the armed monitor's stock SLOs breach
    (["--slo"], True, 3),      # both: fallback beats breach
], ids=["clean", "fallback", "breach", "fallback-beats-breach"])
def test_exit_codes_under_strict_fast_are_jaxs(flags, fallback, want, monkeypatch, capsys):
    if fallback:
        _force_fallback(monkeypatch)
    code, out, err = _both(["--jobs", "2", "--engine", "fast"] + flags, capsys)
    assert code == want and json.loads(out[0])["n_tenants"] == 2
    assert ("scalar loop" in err) == fallback


def _dryrun_record(arch, shape, mesh, status="ok", **kw):
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": status}
    if status == "ok":
        rec["roofline"] = {"dominant": "compute", "compute_s": 0.0123,
                           "memory_s": 0.0045, "collective_s": 0.0006,
                           "useful_flops_fraction": 0.71, "roofline_fraction": 0.412}
    rec.update(kw)
    return rec


def test_roofline_row_reads_a_jax_dryrun_jsonl_as_jax_does(tmp_path, capsys):
    path = tmp_path / "dryrun.jsonl"
    recs = [_dryrun_record("internlm2-1.8b", "train_4k", "v5e-16"),
            _dryrun_record("mamba2-1.3b", "serve", "v5e-16", status="skipped"),
            _dryrun_record("qwen1.5-32b", "train_4k", "v5e-256", status="error",
                           error="RESOURCE_EXHAUSTED: " + "x" * 80),
            _dryrun_record("internlm2-1.8b", "train_4k", "v5e-16", overrides={"remat": "none"}),
            _dryrun_record("mamba2-1.3b", "serve", "v5e-16")]     # the last record wins
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\nnot json\n")
    code, out, _ = _both(["--tables", "roofline", "--roofline", str(path)], capsys)
    row = json.loads(out[0].split(",", 2)[2])
    assert code == 0 and out[0].startswith("roofline,<us>,")
    assert row["_summary"] == "2 ok / 0 skipped / 1 errors"
    assert row["mamba2-1.3b|serve|v5e-16"].startswith("dom=comp c/m/x=12/4/1ms")


def test_roofline_row_without_a_dryrun_names_what_the_port_offers(tmp_path, capsys):
    code, out, _ = _main("port", ["--tables", "roofline", "--roofline",
                                  str(tmp_path / "none.jsonl")], capsys)
    assert code == 0 and out[0].startswith("roofline,-1,")
    error = json.loads(out[0].split(",", 2)[2])["error"]
    assert error == RUN["port"].NO_DRYRUN
    assert "JAX package's dry run" in error and "--roofline FILE" in error


def test_kernel_duets_run_on_the_cpu_when_asked(capsys):
    code, out, _ = _main("port", ["--tables", "kernel_duets", "--device", "cpu"], capsys)
    rows = [line for line in out if ",<us>," in line]
    assert code == 0 and len(rows) == 1 and rows[0].startswith("kernel_duets_real,")
    duets = json.loads(rows[0].split(",", 2)[2])
    names = ["attention_dot_vs_chunked", "rmsnorm_fused_vs_unfused",
             "ssd_recurrence_vs_chunked"]

    assert sorted(duets) == sorted(names + ["invocations", "wall_s"])
    assert duets["invocations"] == 36
    for name in names:
        d = duets[name]
        assert d["n"] == 12 and isinstance(d["changed"], bool)
        lo, hi = d["ci"]
        assert all(math.isfinite(x) for x in (lo, hi, d["median_diff_pct"]))
        assert lo <= d["median_diff_pct"] <= hi
