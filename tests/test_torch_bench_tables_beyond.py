"""The port's beyond-paper tables (``repro_torch.benchmarks.paper_tables``)
against the JAX package's, row for row at base seed 0: parallelism curve,
memory autotune, adaptive vs fixed, service Pareto, multi-tenant
throughput and engine scaling (its live rows' host timings dropped,
``tests/_torch_bench.py::HOST_FIELDS``).  Chaos robustness and the slow
``pipeline_vs_full`` are cases of ``test_torch_bench_tables.py``.
"""
import pytest

from _torch_bench import TABLES_SECOND_FILE, assert_table_equal
from test_torch_obs import restore_contexts  # noqa: F401 (fixture)

# the benchmarks, the tables and the examples install a process-wide obs
# context and default engine (the service, the replan controller, run.py)
# and never put them back
pytestmark = pytest.mark.usefixtures("restore_contexts")


@pytest.mark.parametrize("fn_name", TABLES_SECOND_FILE)
def test_beyond_paper_table_rows_equal_jax(fn_name):
    name, rows = assert_table_equal(fn_name)
    assert name and rows
    if name == "engine_scaling":
        live = [r for k, r in rows.items() if k.startswith("live_n_")]
        assert len(live) == 2 and all(r == {"bit_exact": True} for r in live)
