"""Carry weights between the JAX package's LM and the port's :class:`LM`.

The JAX package stacks every layer's weights along leading axes: ``blocks``,
``encoder`` and ``cross`` along [L], the hybrid ``groups`` along [g] and,
within a group, ``mamba`` [g, per-1], ``dense_ffn`` [g, n_dense] and
``moe`` [g, n_moe] along their second axis.  The port keeps one module per
layer.  ``jax_layout(lm)`` names, for each leaf of the JAX tree by its key
path (``"blocks/attn/wq"``), the port parameters it stacks and where.

* ``params_from_jax(lm, tree)`` copies a JAX parameter pytree (nested
  dicts of numpy arrays: ``jax.tree.map(np.asarray, params)``, made by the
  caller) into ``lm``;
* ``params_to_jax(lm)`` stacks the port's parameters back into that tree
  (torch tensors, copies);
* ``stack_params_(lm)`` does the same without a copy: it makes every
  parameter a view into its stacked leaf and returns the tree, so that an
  update of a stacked leaf (the optimizer's) is an update of the model.

The einsum layouts are kept as they are (``wq`` [D,H,hd], experts'
``w_gate`` [E,D,F], ...), so no transpose can hide a mismatch.  Every key
and every shape must match exactly.  bfloat16 arrays come out of numpy as
``ml_dtypes.bfloat16``, which torch refuses; they go through float32, and
bf16 -> f32 -> bf16 is exact.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models.lm import LM
from repro_torch.train.tree import items, unflatten

Layout = Dict[str, Tuple[tuple, List[Tuple[tuple, nn.Parameter]]]]


def jax_layout(lm: LM) -> Layout:
    """JAX key path -> (stacked shape, [(index into the stacked leaf, port
    parameter)]).  A parameter named ``groups.2.mamba.1.w_x`` in the port
    is ``groups/mamba/w_x`` [2, 1] in JAX: the numbers of a module path are
    the indices, the names the key path."""
    entries: Dict[str, List[Tuple[tuple, nn.Parameter]]] = {}
    for name, p in lm.named_parameters():
        if name == "encoder_norm":
            name = "encoder.final_norm"
        parts = name.split(".")
        key = "/".join(s for s in parts if not s.isdigit())
        entries.setdefault(key, []).append((tuple(int(s) for s in parts if s.isdigit()), p))
    out: Layout = {}
    for key, slots in entries.items():
        lead = tuple(max(idx[a] for idx, _ in slots) + 1 for a in range(len(slots[0][0])))
        out[key] = (lead + tuple(slots[0][1].shape), slots)
    return out


def tensor_from_array(a) -> torch.Tensor:
    """A numpy (or ml_dtypes) array as a CPU tensor; bfloat16 comes as float32."""
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, order="C"))      # 0-d stays 0-d


def params_from_jax(lm: LM, tree: dict) -> LM:
    """Copy the JAX param tree of any family's LM into ``lm``; returns ``lm``."""
    layout = jax_layout(lm)
    flat = dict(items(tree))
    if set(flat) != set(layout):
        raise ValueError(f"params: JAX keys lacking in the port {sorted(set(flat) - set(layout))}, "
                         f"port keys lacking in JAX {sorted(set(layout) - set(flat))}")
    with torch.no_grad():
        for key, (shape, slots) in layout.items():
            src = tensor_from_array(flat[key])
            if tuple(src.shape) != shape:
                raise ValueError(f"{key}: JAX shape {tuple(src.shape)} != port shape {shape}")
            for idx, p in slots:
                p.copy_(src[idx].to(dtype=p.dtype, device=p.device))
    return lm


def params_to_jax(lm: LM) -> dict:
    """The port's parameters as the JAX param tree (stacked copies)."""
    flat = {}
    for key, (shape, slots) in jax_layout(lm).items():
        first = slots[0][1]
        out = torch.empty(shape, dtype=first.dtype, device=first.device)
        with torch.no_grad():
            for idx, p in slots:
                out[idx] = p
        flat[key] = out
    return unflatten(flat)


def stack_params_(lm: LM) -> dict:
    """Rebind every parameter of ``lm`` as a view into its stacked JAX leaf
    and return that tree (the leaves hold the parameters' values)."""
    tree = params_to_jax(lm)
    flat = dict(items(tree))
    for key, (_, slots) in jax_layout(lm).items():
        for idx, p in slots:
            p.data = flat[key][idx]
    return tree
