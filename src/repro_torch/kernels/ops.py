"""Public wrappers around the port's kernels, in the model's layout.

The wrappers accept the model's [B, S, H, hd] layout and convert to the
kernels' head-major layout and back, as ``repro.kernels.ops`` does.
K1's call is the "k1" span (``core.scope``), which counts the bytes of
its layout copies (``copy_bytes``); K3's is the "k3" span, which counts the
bytes of k and v it reads (``bytes``).  K3 reads the model's layout through
its strides and copies nothing.
"""
from __future__ import annotations

from repro_torch.core.scope import named_scope
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd


def flash_attention(q, k, v, *, causal=True, window=None, softmax_scale=None):
    """q [B,Sq,H,hd]; k,v [B,Skv,K,hd] -> [B,Sq,H,hd]."""
    w = 0 if window is None else int(window)
    with named_scope("k1") as sp:
        views = [t.transpose(1, 2) for t in (q, k, v)]
        if sp.recording:
            sp.note(copy_bytes=copy_bytes(*views))
        qh, kh, vh = (t.contiguous() for t in views)
        out = _fa.flash_attention_hmajor(qh, kh, vh, causal=causal, window=w,
                                         softmax_scale=softmax_scale)
        return out.transpose(1, 2)


def decode_attention(q, k, v, *, lo, hi, softmax_scale=None, valid=None):
    """q [B,1,H,hd]; k,v [B,S,K,hd] -> [B,1,H,hd] over keys lo .. hi-1, or
    lo .. min(hi, valid)-1 with a device length ``valid`` (K3)."""
    with named_scope("k3") as sp:
        if sp.recording and valid is None:
            sp.note(bytes=_da.kv_bytes(k, lo, hi))
        elif sp.recording:      # the keys read are known once the step has run
            per_key = _da.kv_bytes(k, 0, 1)
            sp.note_later({"valid": valid}, lambda got: {
                "bytes": per_key * (_da.key_end(lo, hi, got["valid"]) - lo)})
        return _da.decode_attention(q, k, v, lo=lo, hi=hi, softmax_scale=softmax_scale,
                                    valid=valid)


def copy_bytes(*views) -> int:
    """Bytes that ``.contiguous()`` reads and writes to lay ``views`` out."""
    return sum(2 * t.numel() * t.element_size() for t in views if not t.is_contiguous())


def ssd_scan(x, dt, A, B_in, C_in, *, chunk=_ssd.DEFAULT_CHUNK):
    """Model layout: x [B,S,H,P]; dt [B,S,H]; B_in/C_in [B,S,G,N].

    Returns (y [B,S,H,P], state [B,H,P,N])."""
    xh = x.movedim(1, 2).contiguous()            # [B,H,S,P]
    dth = dt.movedim(1, 2).contiguous()          # [B,H,S]
    Bh = B_in.movedim(1, 2).contiguous()         # [B,G,S,N]
    Ch = C_in.movedim(1, 2).contiguous()
    y, state = _ssd.ssd_scan_hmajor(xh, dth, A, Bh, Ch, chunk=chunk)
    return y.movedim(1, 2), state
