"""Training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --reduced --device cpu --steps 20 --ckpt-dir build/ckpt --ckpt-every 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
        --global-batch 8 --accum 4 --steps 4

The counterpart of ``repro.launch.train`` on one device: the same flags
(plus ``--device``), shapes from the ``train_4k`` cell (sequence 4,096,
global batch 256; ``--reduced``: the reduced config at sequence 64, global
batch 4, 2 microbatches), the same synthetic data, optimizer and log line.
Runs on the CUDA card unless ``--device cpu`` is given.  Checkpoints carry
the data-pipeline step; with ``--ckpt-dir`` it resumes from the
latest checkpoint there (a bit-deterministic continuation) and saves every
``--ckpt-every`` steps and at the end, in the JAX package's format.
Attention takes ``cfg.attention_impl`` ("auto": dot up to 2,048
positions, else chunked), as in the JAX package; a Mamba-2 layer's SSD
takes K2 on the card, with the plain scan's gradient.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.models.lm import LM, resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, SyntheticDataset, batch_to_device
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import init_train_state, load_state_, make_train_step


@dataclass
class TrainResult:
    state: dict                   # {"params", "opt"} in the JAX layout
    lm: LM                        # trains on state["params"]
    ocfg: OptimizerConfig         # the optimizer config it trained with
    steps: List[dict]             # per step run: step, loss, lr, grad_norm, seconds
    start_step: int               # 0, or the data step a checkpoint resumed from
    tokens_per_step: int


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true", help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _default_accum(global_batch: int) -> int:
    """Microbatches per step on one device: the JAX cells' rule
    (``repro.launch.cells._default_accum``) at a data axis of 1, which aims
    at 2 sequences per microbatch."""
    accum = max(1, global_batch // 2)
    while global_batch % accum:
        accum -= 1
    return accum


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, *, ocfg: Optional[OptimizerConfig] = None) -> TrainResult:
    """Train ``--steps`` steps.  ``ocfg`` replaces the optimizer config that
    the flags give (learning rate ``--lr``, warmup min(100, steps // 10 +
    1), cosine to ``--steps``)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    shape = SHAPES["train_4k"]
    if args.reduced:
        cfg = cfg.reduced()
        shape = dataclasses.replace(shape, seq_len=64, global_batch=4)
    seq = args.seq_len or shape.seq_len
    gb = args.global_batch or shape.global_batch
    accum = args.accum or (2 if args.reduced else _default_accum(gb))
    if args.reduced:
        accum = min(accum, gb)
    ocfg = ocfg or OptimizerConfig(learning_rate=args.lr,
                                   warmup_steps=min(100, args.steps // 10 + 1),
                                   total_steps=args.steps)

    lm = LM(cfg, device=device, seed=args.seed)
    step_fn = make_train_step(lm, ocfg)
    ds = SyntheticDataset(
        DataConfig(vocab_size=cfg.vocab_size,
                   seq_len=seq - cfg.num_image_tokens if cfg.num_image_tokens else seq,
                   global_batch=gb, accum_steps=accum, seed=args.seed), cfg)

    start_step = 0
    state = init_train_state(lm, ocfg)
    saver = None
    if args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            restored, man = ckpt.restore(args.ckpt_dir, latest, state)
            load_state_(state, restored)
            start_step = man["metadata"]["data_step"]
            print(f"[train] resumed from step {start_step}")
        saver = ckpt.AsyncCheckpointer(args.ckpt_dir)

    tokens_per_step = gb * seq
    steps = []
    t0 = time.time()
    try:
        for step in range(start_step, args.steps):
            t_step = time.perf_counter()
            batch = batch_to_device(ds.batch(step), device)
            state, metrics = step_fn(state, batch)
            m = {k: float(v) for k, v in metrics.items()}
            _sync(device)
            steps.append(dict(step=step, **m, seconds=time.perf_counter() - t_step))
            if step % args.log_every == 0 or step == args.steps - 1:
                tps = tokens_per_step * (step - start_step + 1) / max(time.time() - t0, 1e-9)
                print(f"[train] step {step:5d} loss {m['loss']:7.4f} lr {m['lr']:.2e} "
                      f"gnorm {m['grad_norm']:8.2f} tok/s {tps:,.0f}", flush=True)
            if saver and (step + 1) % args.ckpt_every == 0:
                saver.save(step + 1, state, metadata={"data_step": step + 1})
        if saver:
            saver.save(args.steps, state, metadata={"data_step": args.steps})
    finally:
        if saver:
            saver.close()
    print(f"[train] done in {time.time() - t0:.1f}s")
    return TrainResult(state=state, lm=lm, ocfg=ocfg, steps=steps, start_step=start_step,
                       tokens_per_step=tokens_per_step)


if __name__ == "__main__":
    main()
