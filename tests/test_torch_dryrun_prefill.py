"""The port's dry run at full width on the prefill_32k cells that the
sharding repairs changed, against JAX's records
(``tests/data/jax_dryrun_records.jsonl``, made by the JAX package's own
dry run on the CPU):

* internlm2-1.8b, gemma3-4b and phi3.5-moe-42b-a6.6b on 16x16: per-device
  FLOPs equal JAX's.  Their kv heads stay replicated over the model axis
  while the q heads are cut: each shard projects the kv heads its q heads
  read (not all of them), and the cache it emits is gathered from those
  (phi3.5-moe's 8 kv heads over a model axis of 16 raised "Cannot
  unflatten unevenly sharded tensor" before).
* mamba2-1.3b and jamba-1.5-large-398b on 16x16: per-device FLOPs differ
  from JAX's by ``analysis.parity.ssd_serve_delta`` exactly (K2's causal
  half and whole C·Bᵀ against XLA's whole intra-chunk product and C·Bᵀ
  over the cut state), the B/C projections cut over the model axis as XLA
  cuts them.
* phi3.5-moe and jamba on 2x16x16: the cells run (they raised before).
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_dryrun import derived_delta, jax_record, port_records  # noqa: E402

EQUAL = [("internlm2-1.8b", "prefill_32k", "16x16"), ("gemma3-4b", "prefill_32k", "16x16"),
         ("phi3.5-moe-42b-a6.6b", "prefill_32k", "16x16")]
SSD = [("mamba2-1.3b", "prefill_32k", "16x16"), ("jamba-1.5-large-398b", "prefill_32k", "16x16")]
PODS = [("phi3.5-moe-42b-a6.6b", "prefill_32k", "2x16x16"),
        ("jamba-1.5-large-398b", "prefill_32k", "2x16x16")]


@pytest.fixture(scope="module")
def records():
    return port_records(EQUAL + SSD + PODS)


@pytest.mark.parametrize("cell", EQUAL + SSD + PODS, ids="-".join)
def test_prefill_flops_match_jax(records, cell):
    rec = records[cell]
    assert rec["status"] == "ok", rec.get("error")
    jrec = jax_record(*cell)
    assert rec["plan"] == jrec["plan"]
    delta = derived_delta(rec)
    assert (delta == 0) == (cell in EQUAL or cell[0] == "phi3.5-moe-42b-a6.6b")
    assert rec["roofline"]["hlo_flops"] - jrec["roofline"]["hlo_flops"] == delta
