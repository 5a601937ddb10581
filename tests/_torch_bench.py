"""Shared by the port's benchmark parity tests (``tests/test_torch_bench_*.py``):
the host-clock fields that parity drops, and the two packages' modules.

Every other field of a benchmark's output is a pure function of its seeds
(virtual time over the same NumPy code on both sides), so the tests
compare it exactly.  ``HOST_FIELDS`` is the one list of what they leave
out: each entry is a pattern (``fnmatch``) over the dotted path of a key
in one output, list items by index.
"""
import fnmatch
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:           # the JAX package's top-level benchmarks/
    sys.path.insert(0, str(ROOT))

HOST_FIELDS = {
    # benchmarks/run.py: the CSV's second column and the summary's
    # "(harness Xs)" (masked by ``mask_run_output``); a table's rows
    # hold no host field except engine_scaling's live rows
    "run": ("harness_us",),
    "engine_scaling": ("live_n_*.vec_us_per_inv", "live_n_*.scalar_us_per_inv",
                       "live_n_*.speedup"),
    "chaos_bench": ("harness_us",),
    "obs_bench": ("harness_us",),
    "service_bench.run_profile": ("*.harness_s",),
    "service_bench.run_scaling": ("*.fast_s", "*.reference_s", "*.speedup"),
    "replan_bench": ("replan_vs_static.*.harness_s",),
    "engine_bench": ("*.vec_s", "*.vec_us_per_inv", "*.scalar_s",
                     "*.scalar_us_per_inv", "*.speedup"),
    # (a pattern's "*" spans dots: "*_s" is every key ending in "_s")
    "perf_bench": ("*_s", "*speedup", "env"),
}

PACKAGES = {"jax": "benchmarks", "port": "repro_torch.benchmarks"}


def bench(side, name):
    """The ``name`` benchmark module of ``side`` ("jax" or "port")."""
    return importlib.import_module(f"{PACKAGES[side]}.{name}")


def drop_host_fields(obj, output, path=""):
    """``obj`` without the keys that ``HOST_FIELDS[output]`` names."""
    patterns = HOST_FIELDS[output]
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            p = f"{path}.{k}" if path else str(k)
            if not any(fnmatch.fnmatchcase(p, pat) for pat in patterns):
                out[k] = drop_host_fields(v, output, p)
        return out
    if isinstance(obj, (list, tuple)):
        return [drop_host_fields(v, output, f"{path}.{i}" if path else str(i))
                for i, v in enumerate(obj)]
    return obj


def as_json(obj):
    """Exact comparison form: JSON with sorted keys (an int and a float of
    the same value differ, as in the files the benchmarks write)."""
    return json.dumps(obj, sort_keys=True)


def mask_run_output(text):
    """``run.py``'s stdout with its host column and harness seconds masked:
    ``name,us,rows`` becomes ``name,<us>,rows`` (a ``-1`` error row stays)
    and ``## name  (harness 1.2s)`` becomes ``## name  (harness <s>)``."""
    lines = []
    for line in text.splitlines():
        parts = line.split(",", 2)
        if len(parts) == 3 and parts[2].startswith("{") and parts[1] != "-1":
            line = f"{parts[0]},<us>,{parts[2]}"
        elif line.startswith("## ") and "(harness " in line:
            line = line[:line.index("(harness ")] + "(harness <s>)"
        lines.append(line)
    return lines


# ``paper_tables.ALL_TABLES`` by function name: the paper's own tables, then
# the beyond-paper ones, each set split over two test files so that each file
# stays well under a minute on one core; ``pipeline_vs_full`` takes ~60-80 s
# a side on a CPU and is a slow-marked case of the first file
PAPER_TABLES = ("table_aa", "table_baseline", "table_replication", "table_lowmem",
                "table_single_repeat", "table_possible_changes", "table_ci_repeats",
                "table_time_cost")
BEYOND_TABLES = ("table_parallelism_curve", "table_memory_autotune",
                 "table_adaptive_vs_fixed", "table_service_pareto",
                 "table_multi_tenant_throughput", "table_chaos_robustness",
                 "table_engine_scaling")
TABLES_FIRST_FILE = PAPER_TABLES + ("table_chaos_robustness",)
TABLES_SECOND_FILE = tuple(t for t in BEYOND_TABLES if t not in TABLES_FIRST_FILE)
SLOW_TABLES = ("table_pipeline_vs_full",)


def table_rows(side, fn_name):
    """(name, rows) of one paper table on ``side``, host fields dropped."""
    name, _us, rows = getattr(bench(side, "paper_tables"), fn_name)()
    if name == "engine_scaling":
        rows = drop_host_fields(rows, "engine_scaling")
    return name, rows


def assert_table_equal(fn_name):
    got, want = table_rows("port", fn_name), table_rows("jax", fn_name)
    assert as_json(got) == as_json(want)
    return got
