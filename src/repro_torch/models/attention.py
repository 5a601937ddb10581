"""Attention: GQA, causal / sliding-window, three implementations.

The PyTorch counterpart of ``repro.models.attention``:

    dot      -- materialize scores (small seq; also the decode path)
    chunked  -- a loop over KV chunks with online softmax (the plain twin
                of the flash kernel)
    flash    -- the hand-written K1 kernel (kernels/flash_attention.py) on
                the card, its plain version on the CPU

Shapes: q [B, Sq, H, hd]; k, v [B, Skv, K, hd]; H % K == 0 (GQA groups).
``window`` may be an int or a 0-d tensor: window <= 0 means global.  KV may
be int8 with per-(b,s,k) scales (quantized decode cache).  Score products
run in float32, as the JAX package's ``preferred_element_type`` asks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _mask(q_pos, k_pos, *, causal: bool, window, kv_valid_len=None):
    """q_pos [Sq], k_pos [Sk] (int) -> bool [Sq, Sk]."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if isinstance(window, int):
        if window > 0:
            m &= (q_pos[:, None] - k_pos[None, :]) < window
    elif window is not None:                  # a 0-d tensor
        local = (q_pos[:, None] - k_pos[None, :]) < window
        m &= torch.where(window > 0, local, torch.ones_like(local))
    if kv_valid_len is not None:
        m &= k_pos[None, :] < kv_valid_len
    return m


def _dequant(x, scale):
    if scale is None:
        return x
    # x [B,S,K,hd] int8, scale [B,S,K] f32
    return x.float() * scale[..., None]


def _gqa_scores(q, k):
    """q [B,Sq,K,G,hd], k [B,Sk,K,hd] -> [B,K,G,Sq,Sk] (f32)."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())


def attention_dot(q, k, v, *, causal=True, window=None, q_offset=0,
                  kv_valid_len=None, k_scale=None, v_scale=None,
                  softmax_scale=None):
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    k = _dequant(k, k_scale).to(q.dtype)
    v = _dequant(v, v_scale).to(q.dtype)
    qg = q.reshape(B, Sq, K, G, hd)
    scores = _gqa_scores(qg, k) * scale                      # [B,K,G,Sq,Sk]
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    m = _mask(q_pos, k_pos, causal=causal, window=window, kv_valid_len=kv_valid_len)
    scores = torch.where(m[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(q.dtype).float(), v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def attention_chunked(q, k, v, *, causal=True, window=None, q_offset=0,
                      kv_valid_len=None, k_scale=None, v_scale=None,
                      chunk=1024, softmax_scale=None):
    """Online-softmax over KV chunks; peak memory O(Sq * chunk)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    chunk = min(chunk, Sk)
    n_chunks = (Sk + chunk - 1) // chunk
    pad = n_chunks * chunk - Sk
    if pad:
        def padz(a):
            return F.pad(a, [0, 0] * (a.dim() - 2) + [0, pad])
        k, v = padz(k), padz(v)
        if k_scale is not None:
            k_scale, v_scale = padz(k_scale), padz(v_scale)
        kv_valid_len = min(Sk if kv_valid_len is None else kv_valid_len, Sk)

    qg = (q.reshape(B, Sq, K, G, hd) * scale).to(q.dtype)
    q_pos = q_offset + torch.arange(Sq, device=q.device)

    m_i = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l_i = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, Sq, hd), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        k_c, v_c = k[:, sl], v[:, sl]
        if k_scale is not None:
            k_c = _dequant(k_c, k_scale[:, sl]).to(q.dtype)
            v_c = _dequant(v_c, v_scale[:, sl]).to(q.dtype)
        s = _gqa_scores(qg, k_c)                             # [B,K,G,Sq,C]
        k_pos = ci * chunk + torch.arange(chunk, device=q.device)
        msk = _mask(q_pos, k_pos, causal=causal, window=window,
                    kv_valid_len=kv_valid_len)
        s = torch.where(msk[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m_i, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_i - m_new)
        l_i = l_i * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(q.dtype).float(), v_c.float())
        acc = acc * corr[..., None] + pv
        m_i = m_new
    out = acc / torch.clamp(l_i, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def attention(q, k, v, *, impl="auto", causal=True, window=None, q_offset=0,
              kv_valid_len=None, k_scale=None, v_scale=None, chunk=1024,
              softmax_scale=None):
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_valid_len=kv_valid_len, k_scale=k_scale, v_scale=v_scale,
              softmax_scale=softmax_scale)
    if impl == "auto":
        impl = "chunked" if (q.shape[1] > 2048 or k.shape[1] > 4096) else "dot"
    if impl == "dot":
        return attention_dot(q, k, v, **kw)
    if impl == "chunked":
        return attention_chunked(q, k, v, chunk=chunk, **kw)
    if impl == "flash":
        # K1 takes neither an offset, a valid length nor a quantized cache;
        # refuse them rather than drop them.
        unsupported = [name for name, val in (
            ("q_offset", q_offset if q_offset != 0 else None),
            ("kv_valid_len", kv_valid_len), ("k_scale", k_scale),
            ("v_scale", v_scale)) if val is not None]
        if unsupported:
            raise ValueError(f"attention impl 'flash' does not take {unsupported}")
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    softmax_scale=softmax_scale)
    raise ValueError(f"unknown attention impl {impl!r}")
