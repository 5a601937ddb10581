"""Carry weights of the JAX package's LM into the port's :class:`LM`.

``params_from_jax(lm, tree)`` takes the JAX parameter pytree as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``, made by the
caller) and copies it into ``lm``.  The stacked ``[L, ...]`` leaves are
split into the per-layer modules; the einsum layouts are kept as they are
(``wq`` [D,H,hd], ...), so no transpose can hide a mismatch.  bfloat16
arrays come out of numpy as ``ml_dtypes.bfloat16``, which torch refuses;
they go through float32, and bf16 -> f32 -> bf16 is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.lm import LM


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _copy(dst: torch.Tensor, src, name: str):
    t = _tensor(src)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: JAX shape {tuple(t.shape)} != port shape "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(t.to(dtype=dst.dtype, device=dst.device))


def _expect_keys(tree: dict, keys, where: str):
    if set(tree) != set(keys):
        raise ValueError(f"{where}: JAX keys {sorted(tree)} != port keys {sorted(keys)}")


def params_from_jax(lm: LM, tree: dict) -> LM:
    """Copy the JAX param tree of a dense or SSM LM into ``lm``; returns ``lm``."""
    top = ["embed", "final_norm", "blocks"] + ([] if lm.cfg.tie_embeddings else ["lm_head"])
    _expect_keys(tree, top, "params")
    _copy(lm.embed, tree["embed"], "embed")
    _copy(lm.final_norm, tree["final_norm"], "final_norm")
    if lm.lm_head is not None:
        _copy(lm.lm_head, tree["lm_head"], "lm_head")
    blocks = tree["blocks"]
    # per-layer norms and parameter groups, as the port's blocks name them
    norms, groups = (["ln"], ["mamba"]) if lm.cfg.family == "ssm" else \
        (["ln1", "ln2"], ["attn", "mlp"])
    _expect_keys(blocks, norms + groups, "blocks")
    n_layers = np.asarray(blocks[norms[0]]).shape[0]
    if n_layers != len(lm.blocks):
        raise ValueError(f"JAX has {n_layers} layers, the port {len(lm.blocks)}")
    for group in groups:
        _expect_keys(blocks[group], getattr(lm.blocks[0], group).keys(), f"blocks.{group}")
    for i, blk in enumerate(lm.blocks):
        for norm in norms:
            _copy(getattr(blk, norm), np.asarray(blocks[norm])[i], f"blocks.{norm}[{i}]")
        for group in groups:
            params = getattr(blk, group)
            for name, leaf in blocks[group].items():
                _copy(params[name], np.asarray(leaf)[i], f"blocks.{group}.{name}[{i}]")
    return lm
