"""Mamba-2 (SSD, state-space duality) block [arXiv:2405.21060]: the
counterpart of ``repro.models.ssm``.

Prefill and training evaluate the SSD over the whole sequence in chunks:
on the card through the hand-written K2 kernel, on the CPU through its
plain chunked block decomposition (``kernels.ssd_scan``).  Decode uses the O(1)
recurrence: h = h * exp(A dt) + dt * B (x) x ; y = C . h.  Dtypes follow
the JAX block step by step (softplus, silu, the skip term, the gate and the
norm in float32; the conv tail cached in float32).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_scan_hmajor
from repro_torch.models.layers import rms_norm


def ssd_chunked(x, dt, A, B, C, chunk: int, h0=None):
    """SSD over a full sequence.

    x  [b, S, H, P]   per-head inputs
    dt [b, S, H]      positive step sizes (already softplus'd)
    A  [H]            negative per-head decay
    B  [b, S, G, N]   input projections (G groups, H % G == 0)
    C  [b, S, G, N]   output projections
    h0 optional initial state [b, H, P, N]
    returns (y [b,S,H,P] in x's dtype, h_final [b,H,P,N] fp32)

    CPU tensors take the plain chunked scan with chunks of ``chunk`` rows;
    CUDA tensors take K2 (which tiles by its own chunk length), under
    autograd inside ``SSDScanFn``, whose backward differentiates the plain
    scan with chunks of ``chunk`` rows.
    """
    y, h = ssd_scan_hmajor(
        x.movedim(1, 2).contiguous(), dt.movedim(1, 2).contiguous(), A.float(),
        B.movedim(1, 2).contiguous(), C.movedim(1, 2).contiguous(), chunk=chunk,
        h0=None if h0 is None else h0.float().contiguous())
    return y.movedim(1, 2), h


def ssd_decode_step(h, x, dt, A, B, C):
    """One-token SSD update.

    h [b,H,P,N] f32; x [b,H,P]; dt [b,H]; A [H]; B,C [b,G,N].
    returns (y [b,H,P] in x's dtype, h_new)
    """
    H = h.shape[1]
    hg = H // B.shape[1]
    da = torch.exp(dt.float() * A[None])                          # [b,H]
    Bh = torch.repeat_interleave(B, hg, dim=1).float()            # [b,H,N]
    Ch = torch.repeat_interleave(C, hg, dim=1).float()
    dx = (dt[..., None] * x).float()                              # [b,H,P]
    h_new = h * da[..., None, None] + dx[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", h_new, Ch)
    return y.to(x.dtype), h_new


def causal_conv(x, w, b):
    """Depthwise causal conv. x [B,S,C]; w [W,C]; b [C]."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def causal_conv_step(conv_state, x_new, w, b):
    """conv_state [B, W-1, C] (raw inputs); x_new [B, C] ->
    (out [B,C], new_state [B, W-1, C]).  Types promote as in JAX (a float32
    state with bfloat16 inputs computes in float32)."""
    ct = torch.promote_types(conv_state.dtype, x_new.dtype)
    full = torch.cat([conv_state.to(ct), x_new[:, None].to(ct)], dim=1)   # [B,W,C]
    wt = torch.promote_types(ct, w.dtype)
    out = torch.einsum("bwc,wc->bc", full.to(wt), w.to(wt))
    return out + b, full[:, 1:]


def mamba_block(u, p, cfg: ModelConfig, h0=None, conv0=None, decode: bool = False):
    """Full Mamba-2 mixer.

    u [B,S,D] (S==1 for decode).  p: layer params (dict of tensors).
    conv state = last (W-1) *raw* (pre-conv) xBC rows, concat channels.
    Prefill ignores ``conv0`` and starts the SSD at ``h0`` (zeros if None);
    decode needs both.  Returns (out [B,S,D], (h_final, conv_state_final)).
    """
    s = cfg.ssm
    B_, S, D = u.shape
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    G, N, P = s.n_groups, s.d_state, s.head_dim
    GN = G * N

    z = u @ p["w_z"]
    xc = u @ p["w_x"]                                             # [B,S,di]
    Bp = u @ p["w_B"]                                             # [B,S,G*N]
    Cp = u @ p["w_C"]
    dt = u @ p["w_dt"]                                            # [B,S,nh]
    dt = F.softplus(dt.float() + p["dt_bias"].float())

    xbc_raw = torch.cat([xc, Bp, Cp], dim=-1)
    if decode:
        x0, B0, C0 = conv0[..., :di], conv0[..., di:di + GN], conv0[..., di + GN:]
        xc, _ = causal_conv_step(x0, xc[:, 0], p["conv_w"], p["conv_b"])
        Bp, _ = causal_conv_step(B0, Bp[:, 0], p["conv_wB"], p["conv_bB"])
        Cp, _ = causal_conv_step(C0, Cp[:, 0], p["conv_wC"], p["conv_bC"])
        xc, Bp, Cp = xc[:, None], Bp[:, None], Cp[:, None]
        ct = torch.promote_types(conv0.dtype, xbc_raw.dtype)
        conv_new = torch.cat([conv0.to(ct), xbc_raw.to(ct)], dim=1)[:, 1:]
    else:
        xc = causal_conv(xc, p["conv_w"], p["conv_b"])
        Bp = causal_conv(Bp, p["conv_wB"], p["conv_bB"])
        Cp = causal_conv(Cp, p["conv_wC"], p["conv_bC"])
        W1 = s.conv_width - 1
        tail = xbc_raw[:, -W1:] if S >= W1 else F.pad(xbc_raw, (0, 0, W1 - S, 0))
        conv_new = tail.float()

    def silu(a):
        return F.silu(a.float()).to(u.dtype)

    xc, Bp, Cp = silu(xc), silu(Bp), silu(Cp)
    xh = xc.reshape(B_, S, nh, P)
    Bm = Bp.reshape(B_, S, G, N)
    Cm = Cp.reshape(B_, S, G, N)
    A = -torch.exp(p["a_log"].float())                            # [nh], negative

    if decode:
        y, h_new = ssd_decode_step(h0, xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
        y = y[:, None]
    else:
        y, h_new = ssd_chunked(xh, dt, A, Bm, Cm, chunk=min(s.chunk_size, S), h0=h0)

    y = y + p["d_skip"].float()[None, None, :, None] * xh
    y = y.reshape(B_, S, di)
    y = y * F.silu(z.float()).to(y.dtype)                         # gated
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    out = y.to(u.dtype) @ p["w_out"]
    return out.to(u.dtype), (h_new, conv_new)
