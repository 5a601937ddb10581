"""Plain PyTorch oracles for the port's kernels.

The counterpart of ``repro.kernels.ref``: naive, materialize-everything
versions that define what a kernel computes.
"""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal=True, window=0, kv_valid=None,
                  softmax_scale=None):
    """Naive attention oracle.  q [B,H,Sq,hd]; k,v [B,K,Skv,hd]."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    g = H // K
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    kf = torch.repeat_interleave(k, g, dim=1).float()
    vf = torch.repeat_interleave(v, g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window and window > 0:
        mask &= (q_pos - k_pos) < window
    if kv_valid is not None:
        mask &= k_pos < kv_valid
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return out.to(q.dtype)
