"""The port's dry run at full width on the decode cells that the sharding
repairs changed, against JAX's records
(``tests/data/jax_dryrun_records.jsonl``, made by the JAX package's own
dry run on the CPU):

* internlm2-1.8b and gemma3-4b decode_32k on 16x16 (an int8 cache cut on
  its sequence over the model axis): per-device FLOPs equal JAX's, and
  the collectives within twice JAX's: each shard scores its own keys, and
  the softmax's row max and row sum and P·V are all-reduced, where
  DTensor alone gathered the f32 scores (403.5 MB and 572.7 MB before).
* mamba2-1.3b decode_32k and long_500k on 16x16: equal (the B/C
  projections and their conv cut over the model axis).
* jamba-1.5-large-398b long_500k on 16x16, and phi3.5-moe-42b-a6.6b and
  jamba decode_32k on 2x16x16 (these raised before): per-device FLOPs
  differ from JAX's by ``analysis.parity.fsdp_decode_delta`` exactly (the
  same products split over more shards).
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_dryrun import derived_delta, jax_record, port_records  # noqa: E402

COLLECTIVES = [("internlm2-1.8b", "decode_32k", "16x16"), ("gemma3-4b", "decode_32k", "16x16")]
MAMBA = [("mamba2-1.3b", "decode_32k", "16x16"), ("mamba2-1.3b", "long_500k", "16x16")]
FSDP = [("jamba-1.5-large-398b", "long_500k", "16x16"),
        ("phi3.5-moe-42b-a6.6b", "decode_32k", "2x16x16"),
        ("jamba-1.5-large-398b", "decode_32k", "2x16x16")]


@pytest.fixture(scope="module")
def records():
    return port_records(COLLECTIVES + MAMBA + FSDP)


@pytest.mark.parametrize("cell", COLLECTIVES + MAMBA + FSDP, ids="-".join)
def test_decode_flops_match_jax(records, cell):
    rec = records[cell]
    assert rec["status"] == "ok", rec.get("error")
    jrec = jax_record(*cell)
    delta = derived_delta(rec)
    assert (delta != 0) == (cell in FSDP)
    assert rec["roofline"]["hlo_flops"] - jrec["roofline"]["hlo_flops"] == delta


@pytest.mark.parametrize("cell", COLLECTIVES, ids="-".join)
def test_decode_collectives_within_twice_jax(records, cell):
    rec, jrec = records[cell], jax_record(*cell)
    port, jax = rec["roofline"]["collective_bytes"], jrec["roofline"]["collective_bytes"]
    assert 0 < port <= 2 * jax, (port, jax, rec["roofline"]["collective_detail"])
