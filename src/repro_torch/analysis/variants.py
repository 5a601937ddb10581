"""Fused-kernel (deployment-path) roofline adjustment: the counterpart of
``repro.analysis.variants``, with the HBM bandwidth of the card reckoned
for (analysis/roofline.py).

The plain attention/SSD paths materialize their internals (scores, probs,
decay matrices) to HBM, and the account's traffic reflects that.  The
deployment path runs these blocks as the hand-written kernels (K1,
kernels/flash_attention.py; K2, kernels/ssd_scan.py), whose only HBM
traffic is the block inputs/outputs.

``adjusted_memory_term(record)`` therefore replaces the measured in-scope
traffic (scope tags "attention_core"/"ssd_core", analysis/account.py) with
an analytic input/output byte count for the kernels, scaled by the same
fwd/bwd/remat multiplicity as in the JAX package.  The port's tags cover
the forward only (account.py), so on a train record the removed bytes are
the forward's.
"""
from __future__ import annotations

from repro_torch.analysis.roofline import DEFAULT_DEVICE, device_spec
from repro_torch.configs.base import ModelConfig, ShapeConfig


def _bwd_multiplicity(remat: str) -> float:
    """fwd + bwd (~2x fwd reads) + remat-full recompute (~1x)."""
    return 4.5 if remat == "full" else 3.5


def attention_io_bytes(cfg: ModelConfig, shape: ShapeConfig, plan,
                       n_devices: int, accum: int) -> float:
    """Per-device QKVO bytes across the whole step (all layers)."""
    if cfg.num_heads == 0:
        return 0.0
    tokens_dev = shape.seq_len * shape.global_batch / max(
        plan.info.data_size, 1)
    if shape.kind == "decode":
        # q/o are single-token; kv cache reads dominate: S*K*hd per head set
        kv = (shape.seq_len * plan.K * cfg.head_dim * 2
              * (1 if shape.kv_cache_dtype == "int8" else 2))
        per_layer = shape.global_batch / max(plan.info.data_size, 1) * kv
        mult = 1.0
    else:
        qo = tokens_dev * plan.H * cfg.head_dim * 2 * 2      # Q + O bf16
        kv = tokens_dev * plan.K * cfg.head_dim * 2 * 2      # K + V
        per_layer = qo + kv
        mult = _bwd_multiplicity(cfg.remat) if shape.kind == "train" else 1.0
    n_attn = sum(1 for i in range(cfg.num_layers) if cfg.is_attn_layer(i))
    return per_layer * n_attn * mult


def ssd_io_bytes(cfg: ModelConfig, shape: ShapeConfig, plan,
                 n_devices: int, accum: int) -> float:
    if cfg.ssm is None:
        return 0.0
    s = cfg.ssm
    tokens_dev = shape.seq_len * shape.global_batch / max(
        plan.info.data_size, 1)
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    # x, y (di each, bf16) + dt (nh) + B,C (2*G*N f32) per token
    per_tok = (2 * di * 2 + nh * 2 + 2 * s.n_groups * s.d_state * 4)
    n_ssm = sum(1 for i in range(cfg.num_layers)
                if not cfg.is_attn_layer(i)) if cfg.hybrid is not None \
        else cfg.num_layers
    mult = _bwd_multiplicity(cfg.remat) if shape.kind == "train" else 1.0
    return tokens_dev * per_tok * n_ssm * mult


def adjusted_memory_term(rec: dict, plan, cfg: ModelConfig,
                         shape: ShapeConfig) -> dict:
    """Returns {'hbm_bytes', 'memory_s', 'removed_bytes', 'added_bytes'};
    memory_s at the HBM bandwidth of the record's device (a JAX record names
    none: ``DEFAULT_DEVICE``)."""
    device = rec.get("device", DEFAULT_DEVICE)
    t = rec["roofline"]
    tags = rec.get("traffic_by_tag", {})
    removed = sum(tags.values())
    added = 0.0
    if "attention_core" in tags:
        added += attention_io_bytes(cfg, shape, plan, t["n_devices"],
                                    rec.get("accum_steps", 1))
    if "ssd_core" in tags:
        added += ssd_io_bytes(cfg, shape, plan, t["n_devices"],
                              rec.get("accum_steps", 1))
    new_bytes = max(t["hbm_bytes"] - removed + added, 0.0)
    return {"hbm_bytes": new_bytes, "memory_s": new_bytes / device_spec(device).hbm_bw,
            "removed_bytes": removed, "added_bytes": added}
