"""Deterministic synthetic data: the counterpart of ``repro.train.data``.

Batches are a pure function of (seed, step), drawn in NumPy exactly as the
JAX package draws them, so the two give the same arrays bit for bit.  The
iterator's "state" is the step counter, which makes data-pipeline
checkpointing exact and restarts deterministic.  Token streams follow a
Zipfian unigram distribution with short-range repetition, so the LM loss
decreases during a run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    accum_steps: int = 1
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticDataset:
    def __init__(self, cfg: DataConfig, model_cfg: Optional[ModelConfig] = None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** -cfg.zipf_a
        self.probs = p / p.sum()

    def batch(self, step: int) -> dict:
        """The host-side NumPy batch for ``step``: microbatch = global_batch
        // accum_steps; tokens/labels have shape [accum_steps, microbatch,
        seq]."""
        c = self.cfg
        if c.global_batch % c.accum_steps:
            raise ValueError(f"global batch {c.global_batch} is not a multiple of "
                             f"accum_steps {c.accum_steps}")
        mb = c.global_batch // c.accum_steps
        rng = np.random.default_rng(np.random.SeedSequence([c.seed, step]))
        toks = rng.choice(c.vocab_size, size=(c.accum_steps, mb, c.seq_len),
                          p=self.probs).astype(np.int32)
        # short-range structure: repeat the previous token with p=0.3
        rep = rng.random((c.accum_steps, mb, c.seq_len)) < 0.3
        rep[..., 0] = False
        toks = np.where(rep, np.roll(toks, 1, axis=-1), toks)
        out = {"tokens": toks, "labels": toks}
        m = self.model_cfg
        if m is not None and m.encoder is not None:
            out["enc_embeds"] = rng.standard_normal(
                (c.accum_steps, mb, m.encoder.source_len, m.d_model),
                dtype=np.float32) * 0.02
        if m is not None and m.num_image_tokens:
            out["embeds_prefix"] = rng.standard_normal(
                (c.accum_steps, mb, m.num_image_tokens, m.d_model),
                dtype=np.float32) * 0.02
        return out


def batch_to_device(batch: dict, device) -> dict:
    """The host batch as tensors on ``device``: token ids as int64 (what
    ``LM.forward`` indexes with), embeddings as float32."""
    return {k: torch.from_numpy(v).to(device=device,
                                      dtype=torch.long if v.dtype.kind == "i" else None)
            for k, v in batch.items()}


def shard_batch(batch: dict, plan) -> dict:
    """A device batch ([accum, mb, ...] tensors) placed with its microbatch
    dim sharded over the data axes (dim 1 after accum), as JAX's
    ``shard_batch`` puts it; on a one-device plan the batch as it is."""
    from repro_torch.models.layers import place
    d = plan.spec("batch")[0]
    return {k: place(v, plan, (None, d) + (None,) * (v.dim() - 2)) for k, v in batch.items()}
