"""Public wrappers around the port's kernels, in the model's layout.

The wrappers accept the model's [B, S, H, hd] layout and convert to the
kernels' head-major layout and back, as ``repro.kernels.ops`` does.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd


def flash_attention(q, k, v, *, causal=True, window=None, softmax_scale=None):
    """q [B,Sq,H,hd]; k,v [B,Skv,K,hd] -> [B,Sq,H,hd]."""
    w = 0 if window is None else int(window)
    qh = q.transpose(1, 2).contiguous()
    kh = k.transpose(1, 2).contiguous()
    vh = v.transpose(1, 2).contiguous()
    out = _fa.flash_attention_hmajor(qh, kh, vh, causal=causal, window=w,
                                     softmax_scale=softmax_scale)
    return out.transpose(1, 2)


def ssd_scan(x, dt, A, B_in, C_in, *, chunk=_ssd.DEFAULT_CHUNK):
    """Model layout: x [B,S,H,P]; dt [B,S,H]; B_in/C_in [B,S,G,N].

    Returns (y [B,S,H,P], state [B,H,P,N])."""
    xh = x.movedim(1, 2).contiguous()            # [B,H,S,P]
    dth = dt.movedim(1, 2).contiguous()          # [B,H,S]
    Bh = B_in.movedim(1, 2).contiguous()         # [B,G,S,N]
    Ch = C_in.movedim(1, 2).contiguous()
    y, state = _ssd.ssd_scan_hmajor(xh, dth, A, Bh, Ch, chunk=chunk)
    return y.movedim(1, 2), state
