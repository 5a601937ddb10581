"""End-to-end training example.

Default: a ~15M-param reduced internlm2 for 200 steps (loss drops
visibly).  ``--size 100m`` trains a ~100M-param config (sized
for a real accelerator host).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --size 100m --steps 300

The port's twin of the JAX package's ``examples/train_lm.py``: the same
flags to ``repro_torch.launch.train`` (plus ``--device``, the CUDA card
unless ``--device cpu`` is given).  Checkpoints go to ``--ckpt-dir``,
``build/train_lm_example`` by default.
"""
import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.configs.base import register
from repro_torch.launch import train as train_mod


def make_100m() -> str:
    """~100M-param dense LM registered as a selectable config."""
    base = get_config("internlm2-1.8b")
    cfg = dataclasses.replace(
        base, name="dense-100m", num_layers=12, d_model=768, num_heads=12,
        num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32768,
        remat="none")
    register(cfg)
    return cfg.name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", choices=["tiny", "100m"], default="tiny")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default="build/train_lm_example")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.size == "100m":
        arch = make_100m()
        argv = ["--arch", arch, "--steps", str(args.steps),
                "--seq-len", "512", "--global-batch", "8", "--accum", "4",
                "--lr", "1e-3", "--ckpt-dir", args.ckpt_dir,
                "--ckpt-every", "100"]
    else:
        argv = ["--arch", "internlm2-1.8b", "--reduced",
                "--steps", str(args.steps), "--lr", "3e-3",
                "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100"]
    return train_mod.main(argv + ["--device", args.device])


if __name__ == "__main__":
    main()
