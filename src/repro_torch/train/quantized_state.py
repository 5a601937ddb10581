"""Block-wise int8 optimizer state (8-bit Adam, after Dettmers et al.
[arXiv:2110.02861]): the counterpart of ``repro.train.quantized_state``.

A tensor is flattened and cut into blocks of ``BLOCK`` trailing elements
(the last block zero-padded); each block keeps an fp32 absmax scale and
int8 codes ``round(x / scale)``.  ``torch.round`` rounds half to even, as
``jnp.round`` does, so the codes equal the JAX package's bit for bit.  m
and v drop from 8 to ~2.03 bytes per parameter.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256


def n_blocks(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return (n + BLOCK - 1) // BLOCK


def _blocks(flat: torch.Tensor) -> torch.Tensor:
    """A flat tensor zero-padded to whole blocks, as [n_blocks, BLOCK]."""
    return F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)


def q8_encode(x: torch.Tensor):
    """x -> (q int8 with x's shape, scale fp32 [n_blocks])."""
    blocks = _blocks(x.float().reshape(-1))
    scale = torch.clamp(torch.amax(torch.abs(blocks), dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127)
    return q.reshape(-1)[:x.numel()].to(torch.int8).reshape(x.shape), scale


def q8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    out = (_blocks(q.float().reshape(-1)) * scale[:, None]).reshape(-1)
    return out[:q.numel()].reshape(q.shape)


def state_bytes(tree) -> int:
    """Actual byte footprint of a (possibly quantized) state: a nest of
    dicts of tensors."""
    if isinstance(tree, dict):
        return sum(state_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()
