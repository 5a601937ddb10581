"""The port's dry run of the SSD train cells at full width on 16x16,
against JAX's records (``tests/data/jax_dryrun_records.jsonl``, made by
``PYTHONPATH=src python -m repro.launch.dryrun --arch A --shape train_4k
--accum 1``): one microbatch of the whole per-device batch, which JAX's
records show takes the same per-device FLOPs as the default 8 microbatches
(and which the port traces 8 times faster).

* mamba2-1.3b (remat "dots"): 4.619e13 FLOPs a device against JAX's
  4.644e13 (9.650e13 before: the backward gathered activations and weights
  where JAX has no all-gather).  The difference is the SSD's, derived by
  ``analysis.parity.ssd_train_delta``: K2's forward and the plain scan
  rerun and differentiated in ``SSDScanFn``'s backward, against XLA's
  four forwards of the jnp scan.  Its all-gathers: 0.52 GB (477.8 GB
  before), each half of a move XLA makes as an all-reduce: the embedding
  lookup's sum over the vocab shards (DTensor's reduce-scatter and
  all-gather), the ZeRO-1 parameters gathered back after the update, and
  the conv state's tail rows.
* jamba-1.5-large-398b (remat "full", FSDP): the SSD as above, with K2 run
  again by the recompute, plus ``parity.fsdp_train_delta``: XLA splits the
  FSDP-cut B/C projections' weight gradient over the model axis, the port
  computes it whole on each model shard.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_dryrun import derived_delta, jax_record, port_records  # noqa: E402

CELLS = [("mamba2-1.3b", "train_4k", "16x16", 1), ("jamba-1.5-large-398b", "train_4k", "16x16", 1)]


@pytest.fixture(scope="module")
def records():
    return port_records(CELLS)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c[0])
def test_ssd_train_flops_match_jax(records, cell):
    rec = records[cell[:3]]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["accum_steps"] == 1
    jrec = jax_record(*cell)
    assert rec["plan"] == jrec["plan"]
    delta = derived_delta(rec)
    assert delta > 0 if cell[0].startswith("jamba") else delta < 0
    assert rec["roofline"]["hlo_flops"] - jrec["roofline"]["hlo_flops"] == delta
    assert "all-reduce" in rec["roofline"]["collective_detail"]


def test_mamba2_train_gathers_under_1_gb(records):
    rec = records[CELLS[0][:3]]
    gathered = rec["roofline"]["collective_detail"].get("all-gather", 0)
    assert gathered < 1e9, rec["roofline"]["collective_detail"]
