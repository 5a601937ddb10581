"""Public wrappers around the port's kernels, in the model's layout.

The wrappers accept the model's [B, S, H, hd] layout and convert to the
kernels' head-major layout and back, as ``repro.kernels.ops`` does.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa


def flash_attention(q, k, v, *, causal=True, window=None, softmax_scale=None):
    """q [B,Sq,H,hd]; k,v [B,Skv,K,hd] -> [B,Sq,H,hd]."""
    w = 0 if window is None else int(window)
    qh = q.transpose(1, 2).contiguous()
    kh = k.transpose(1, 2).contiguous()
    vh = v.transpose(1, 2).contiguous()
    out = _fa.flash_attention_hmajor(qh, kh, vh, causal=causal, window=w,
                                     softmax_scale=softmax_scale)
    return out.transpose(1, 2)
