"""Carry weights of the JAX package's LM into the port's :class:`LM`.

``params_from_jax(lm, tree)`` takes the JAX parameter pytree as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``, made by the
caller) and copies it into ``lm``.  The stacked leaves are split into the
per-layer modules: ``blocks``, ``encoder`` and ``cross`` along [L], the
hybrid ``groups`` along [g] and, within a group, ``mamba`` [g, per-1],
``dense_ffn`` [g, n_dense] and ``moe`` [g, n_moe] along their second axis.
The einsum layouts are kept as they are (``wq`` [D,H,hd], experts'
``w_gate`` [E,D,F], ...), so no transpose can hide a mismatch.  Every key
and every shape must match exactly.  bfloat16 arrays come out of numpy as
``ml_dtypes.bfloat16``, which torch refuses; they go through float32, and
bf16 -> f32 -> bf16 is exact.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

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


def _expect_lead(tree: dict, n: int, axis: int, where: str):
    """Every leaf of the stacked ``tree`` has ``n`` entries along ``axis``."""
    def leaves(t):
        return [x for v in t.values() for x in (leaves(v) if isinstance(v, dict) else [v])]
    got = {np.asarray(x).shape[axis] for x in leaves(tree)}
    if got != {n}:
        raise ValueError(f"{where}: JAX stacks {sorted(got)} along axis {axis}, the port "
                         f"has {n}")


def _copy_dict(dst: nn.ParameterDict, tree: dict, index: tuple, where: str):
    _expect_keys(tree, dst.keys(), where)
    for name, leaf in tree.items():
        _copy(dst[name], np.asarray(leaf)[index], f"{where}.{name}{list(index)}")


def _copy_layers(modules: nn.ModuleList, tree: dict, where: str):
    """Split a stacked [L, ...] tree into per-layer modules: each key names
    a parameter (a norm) or a ParameterDict (a group) of every module."""
    own = {name for name, _ in modules[0].named_parameters(recurse=False)}
    own |= {name for name, _ in modules[0].named_children()}
    _expect_keys(tree, own, where)
    _expect_lead(tree, len(modules), 0, where)
    for i, mod in enumerate(modules):
        for key, sub in tree.items():
            if isinstance(sub, dict):
                _copy_dict(getattr(mod, key), sub, (i,), f"{where}.{key}")
            else:
                _copy(getattr(mod, key), np.asarray(sub)[i], f"{where}.{key}[{i}]")


def _copy_groups(lm: LM, tree: dict):
    """The hybrid stack: ``groups`` [g, ...], with the Mamba mixers and the
    dense and MoE FFNs stacked again within a group."""
    stacked = ("mamba", "dense_ffn", "moe")
    _expect_keys(tree, ["ln_mix", "ln_ffn", "attn", *stacked], "groups")
    _expect_lead(tree, len(lm.groups), 0, "groups")
    for name in stacked:
        _expect_lead(tree[name], len(getattr(lm.groups[0], name)), 1, f"groups.{name}")
    for g, grp in enumerate(lm.groups):
        for norm in ("ln_mix", "ln_ffn"):
            _copy(getattr(grp, norm), np.asarray(tree[norm])[g], f"groups.{norm}[{g}]")
        _copy_dict(grp.attn, tree["attn"], (g,), "groups.attn")
        for name in stacked:
            for j, params in enumerate(getattr(grp, name)):
                _copy_dict(params, tree[name], (g, j), f"groups.{name}")


def params_from_jax(lm: LM, tree: dict) -> LM:
    """Copy the JAX param tree of any family's LM into ``lm``; returns ``lm``."""
    cfg = lm.cfg
    stack = "groups" if cfg.family == "hybrid" else "blocks"
    top = ["embed", "final_norm", stack] + ([] if cfg.tie_embeddings else ["lm_head"])
    if cfg.encoder is not None:
        top += ["encoder", "cross"]
    _expect_keys(tree, top, "params")
    _copy(lm.embed, tree["embed"], "embed")
    _copy(lm.final_norm, tree["final_norm"], "final_norm")
    if lm.lm_head is not None:
        _copy(lm.lm_head, tree["lm_head"], "lm_head")
    if stack == "groups":
        _copy_groups(lm, tree["groups"])
    else:
        _copy_layers(lm.blocks, tree["blocks"], "blocks")
    if cfg.encoder is not None:
        enc = dict(tree["encoder"])
        if "final_norm" not in enc:
            raise ValueError(f"encoder: JAX keys {sorted(enc)} lack final_norm")
        _copy(lm.encoder_norm, enc.pop("final_norm"), "encoder.final_norm")
        _copy_layers(lm.encoder, enc, "encoder")
        _copy_layers(lm.cross, tree["cross"], "cross")
    return lm
