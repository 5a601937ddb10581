"""``repro_torch.train.checkpoint``: the cases of tests/test_checkpoint.py
on the port (all but the multi-device restore: the port runs on one
device), and bfloat16, int8 and scalar leaves in the JAX package's format.
Checkpoints across the two frameworks are in test_torch_train_step.py.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.tree import items  # noqa: E402


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "b": {"c": torch.arange(6, dtype=torch.int32), "d": torch.tensor(3.5)}}


def _equal(a, b):
    assert [k for k, _ in items(a)] == [k for k, _ in items(b)]
    for (key, x), (_, y) in zip(items(a), items(b)):
        assert x.dtype == y.dtype and x.shape == y.shape, key
        assert torch.equal(x, y), key


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t, metadata={"data_step": 7})
    restored, manifest = ckpt.restore(str(tmp_path), 7, t)
    assert manifest["step"] == 7
    assert manifest["metadata"]["data_step"] == 7
    _equal(restored, t)


def test_latest_and_gc(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, t, keep_last=3)
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.all_steps(str(tmp_path)) == [3, 4, 5]


def test_restore_shape_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros((2, 2))})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros((3, 3))})


def test_restore_missing_leaf_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(2), "b": torch.zeros(2)})


def test_interrupted_save_leaves_no_partial_checkpoint(tmp_path):
    """a .tmp dir (crash before rename) is never listed as a checkpoint."""
    os.makedirs(tmp_path / "step_9.tmp")
    assert ckpt.all_steps(str(tmp_path)) == []


def test_async_checkpointer(tmp_path):
    t = _tree()
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep_last=2)
    ac.save(1, t)
    ac.save(2, t, metadata={"x": 1})
    ac.close()
    assert ckpt.all_steps(str(tmp_path)) == [1, 2]
    restored, man = ckpt.restore(str(tmp_path), 2, t)
    assert man["metadata"]["x"] == 1
    _equal(restored, t)


def test_async_save_snapshots_the_tree(tmp_path):
    """The training loop goes on updating its state in place after ``save``
    returns: the checkpoint holds the values at the call."""
    t = {"w": torch.ones(1000)}
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    ac.save(1, t)
    t["w"].add_(1.0)
    ac.close()
    restored, _ = ckpt.restore(str(tmp_path), 1, t)
    assert torch.equal(restored["w"], torch.ones(1000))


def test_bf16_int8_and_scalar_leaves_in_the_jax_format(tmp_path):
    w = torch.randn((3, 5), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    t = {"params": {"w": w}, "opt": {"m": {"w": {"q": torch.tensor([[-127, 0, 5]],
                                                                   dtype=torch.int8),
                                                "scale": torch.ones(1)}},
                                     "step": torch.tensor(4, dtype=torch.int32)}}
    ckpt.save(str(tmp_path), 4, t, metadata={"data_step": 4})
    with open(tmp_path / "step_4" / "manifest.json") as f:
        man = json.load(f)
    assert list(man["leaves"]) == ["opt/m/w/q", "opt/m/w/scale", "opt/step", "params/w"]
    assert man["leaves"]["params/w"] == {"file": "params__w.npy", "shape": [3, 5],
                                         "dtype": "bfloat16"}
    assert man["leaves"]["opt/step"]["shape"] == [] and man["leaves"]["opt/step"]["dtype"] == "int32"
    raw = np.load(tmp_path / "step_4" / "params__w.npy")
    assert raw.dtype == np.uint16                # the bf16 bits, as the JAX package writes them
    np.testing.assert_array_equal(raw, w.view(torch.int16).numpy().view(np.uint16))
    restored, _ = ckpt.restore(str(tmp_path), 4, t)
    _equal(restored, t)


def test_restore_casts_to_the_target(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.tensor([1.5, -2.25]).to(torch.bfloat16)})
    restored, _ = ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(2)})
    assert restored["a"].dtype == torch.float32
    assert restored["a"].tolist() == [1.5, -2.25]
