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


def ssd_ref(x, dt, A, B_in, C_in, h0=None):
    """Exact SSD recurrence oracle (fp32, step by step).

    x [B,H,S,P]; dt [B,H,S]; A [H]; B_in/C_in [B,G,S,N].
    Returns (y [B,H,S,P] in x's dtype, final state [B,H,P,N] fp32).

        h_t = h_{t-1} * exp(A dt_t) + dt_t * (B_t outer x_t)
        y_t = C_t . h_t
    """
    Bz, H, S, P = x.shape
    G, N = B_in.shape[1], B_in.shape[3]
    hg = H // G
    Bh = torch.repeat_interleave(B_in, hg, dim=1).float()   # [B,H,S,N]
    Ch = torch.repeat_interleave(C_in, hg, dim=1).float()
    xf, dtf, Af = x.float(), dt.float(), A.float()
    h = (torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        dtt = dtf[:, :, t]                                     # [B,H]
        decay = torch.exp(dtt * Af[None, :])
        h = (h * decay[..., None, None]
             + (dtt[..., None] * xf[:, :, t])[..., None] * Bh[:, :, t, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, :, t]))
    y = torch.stack(ys, dim=2)                                 # [B,H,S,P]
    return y.to(x.dtype), h
