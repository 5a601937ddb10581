"""End to end on the CPU: the cases of tests/test_system.py on the port
(the loss decreases over 30 steps, the metrics stay finite, a restart from
a checkpoint continues bit for bit, the trained model decodes), and the
entry point ``python -m repro_torch.launch.train``: ``--reduced --device cpu``
trains, writes checkpoints and resumes from the latest one.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticDataset, batch_to_device  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.train.train_step import (init_train_state, load_state_,  # noqa: E402
                                          make_train_step)
from repro_torch.train.tree import items  # noqa: E402

OCFG = OptimizerConfig(learning_rate=1e-2, warmup_steps=5, weight_decay=0.0)


def _setup():
    cfg = get_config("internlm2-1.8b").reduced()
    lm = LM(cfg, device="cpu", seed=0)
    state = init_train_state(lm, OCFG)
    ds = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4,
                                     accum_steps=2), cfg)
    return lm, state, make_train_step(lm, OCFG), ds


@pytest.fixture(scope="module")
def trained():
    lm, state, step_fn, ds = _setup()
    losses = []
    for step in range(30):
        state, m = step_fn(state, batch_to_device(ds.batch(step), "cpu"))
        losses.append(float(m["loss"]))
    return lm, step_fn, ds, state, losses


def test_loss_decreases(trained):
    losses = trained[-1]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


def test_metrics_finite(trained):
    assert all(math.isfinite(x) for x in trained[-1])


def test_checkpoint_restart_bit_exact(tmp_path, trained):
    """a node failure: checkpoint at step 30, train on to 32; restore step
    30 into a fresh model and state, replay the same data steps: the same
    losses and the same state, bit for bit."""
    _, step_fn, ds, state, _ = trained
    ckpt.save(str(tmp_path), 30, state, metadata={"data_step": 30})
    ref_losses = []
    for step in (30, 31):
        state, m = step_fn(state, batch_to_device(ds.batch(step), "cpu"))
        ref_losses.append(float(m["loss"]))
    lm2, state2, step_fn2, _ = _setup()
    restored, man = ckpt.restore(str(tmp_path), 30, state2)
    load_state_(state2, restored)
    assert man["metadata"]["data_step"] == 30
    new_losses = []
    for step in (30, 31):
        state2, m = step_fn2(state2, batch_to_device(ds.batch(step), "cpu"))
        new_losses.append(float(m["loss"]))
    assert new_losses == ref_losses
    for (key, a), (_, b) in zip(items(state), items(state2)):
        assert torch.equal(a, b), key


def test_decode_after_training(trained):
    lm = trained[0]
    cache = lm.init_cache(2, 64, "int8")
    with torch.inference_mode():
        logits, _ = lm.decode(cache, torch.ones((2, 1), dtype=torch.long), 5)
    assert logits.shape[0] == 2 and bool(torch.isfinite(logits.float()).all())


def test_launch_trains_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["--reduced", "--device", "cpu", "--steps", "4", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--log-every", "1"]
    res = train.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[:3] for line in out[:4]] == [["[train]", "step", str(s)]
                                                      for s in range(4)]
    assert res.start_step == 0 and len(res.steps) == 4 and res.tokens_per_step == 4 * 64
    assert all(math.isfinite(s["loss"]) for s in res.steps)
    assert ckpt.all_steps(str(tmp_path)) == [2, 4]
    saved, man = ckpt.restore(str(tmp_path), 4, res.state)
    assert man["metadata"] == {"data_step": 4}
    for (key, a), (_, b) in zip(items(saved), items(res.state)):
        assert torch.equal(a, b), key
    # a longer run in the same directory resumes from step 4
    res2 = train.main([*argv[:4], "6", *argv[5:]])
    assert "[train] resumed from step 4" in capsys.readouterr().out
    assert res2.start_step == 4 and [s["step"] for s in res2.steps] == [4, 5]
    assert ckpt.latest_step(str(tmp_path)) == 6


def test_launch_takes_every_family_on_the_cpu():
    for arch in ("mamba2-1.3b", "whisper-medium", "llava-next-34b"):
        res = train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "1",
                          "--seq-len", "16", "--log-every", "1"])
        assert math.isfinite(res.steps[0]["loss"]), arch


def test_default_accumulation_aims_at_two_sequences_a_microbatch():
    assert train._default_accum(256) == 128          # train_4k on one device
    assert train._default_accum(8) == 4
    assert train._default_accum(1) == 1
    assert train._default_accum(6) == 3
