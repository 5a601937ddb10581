"""Port parity for ``repro_torch.train.data``: the synthetic data pipeline.

The cases of tests/test_data.py on the port, then its batches against
``repro.train.data`` bit for bit over seeds and steps (the enc-dec frames
and the vlm image prefix included), and ``batch_to_device``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.train import data as jax_data  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticDataset, batch_to_device  # noqa: E402


def test_batch_deterministic_per_step():
    ds = SyntheticDataset(DataConfig(vocab_size=100, seq_len=16, global_batch=8,
                                     accum_steps=2, seed=3))
    b1, b2, b3 = ds.batch(5), ds.batch(5), ds.batch(6)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_shapes_and_ranges():
    ds = SyntheticDataset(DataConfig(vocab_size=50, seq_len=12, global_batch=6, accum_steps=3))
    b = ds.batch(0)
    assert b["tokens"].shape == (3, 2, 12)
    assert b["tokens"].dtype == np.int32
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 50
    np.testing.assert_array_equal(b["tokens"], b["labels"])


def test_modality_extras_present():
    cfg = get_config("whisper-medium").reduced()
    b = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2),
                         cfg).batch(0)
    assert b["enc_embeds"].shape == (1, 2, cfg.encoder.source_len, cfg.d_model)
    cfg = get_config("llava-next-34b").reduced()
    b = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2),
                         cfg).batch(0)
    assert b["embeds_prefix"].shape == (1, 2, cfg.num_image_tokens, cfg.d_model)


def test_zipf_distribution_skews_low_ids():
    b = SyntheticDataset(DataConfig(vocab_size=1000, seq_len=256, global_batch=8)).batch(0)
    assert np.mean(b["tokens"].ravel() < 100) > 0.5    # Zipf mass at low ranks


def test_ragged_accumulation_raises():
    ds = SyntheticDataset(DataConfig(vocab_size=10, seq_len=4, global_batch=6, accum_steps=4))
    with pytest.raises(ValueError, match="accum_steps"):
        ds.batch(0)


@pytest.mark.parametrize("arch", [None, "whisper-medium", "llava-next-34b"])
@pytest.mark.parametrize("seed", [0, 1, 17])
def test_batches_equal_jax_bit_for_bit(arch, seed):
    kw = dict(vocab_size=300, seq_len=24, global_batch=6, accum_steps=3, seed=seed)
    cfg = None if arch is None else get_config(arch).reduced()
    jcfg = None if arch is None else jax_get_config(arch).reduced()
    ds = SyntheticDataset(DataConfig(**kw), cfg)
    jds = jax_data.SyntheticDataset(jax_data.DataConfig(**kw), jcfg)
    for step in (0, 1, 5, 1000):
        got, want = ds.batch(step), jds.batch(step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{key} step {step}")


def test_batch_to_device_gives_long_tokens_and_float_embeddings():
    cfg = get_config("llava-next-34b").reduced()
    b = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=4,
                                    accum_steps=2), cfg).batch(3)
    t = batch_to_device(b, "cpu")
    assert t["tokens"].dtype == torch.long and t["tokens"].shape == (2, 2, 8)
    assert t["embeds_prefix"].dtype == torch.float32
    np.testing.assert_array_equal(t["labels"].numpy(), b["labels"])
    np.testing.assert_array_equal(t["embeds_prefix"].numpy(), b["embeds_prefix"])
