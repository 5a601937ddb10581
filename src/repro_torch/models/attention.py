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
The dot and chunked paths run inside the "attention_core" scope
(``core.scope.named_scope``), as JAX's run in its named scope: the
account sums their traffic by that tag.  As a span it counts
``cast_bytes``: what the float32 casts of k and v read and write.

A "dot" call of one query row on the card goes to K3, the decode-attention
kernel (kernels/decode_attention.py), when ``k3_refusal`` finds nothing
against it: it reads the bf16 or f16 cache in place, only the keys the
row attends to, with no float32 cast (its "attention_core" span notes
``cast_bytes`` 0).  A decode step replayed as a CUDA graph passes its
position as a device tensor (``kv_valid_len`` = position + 1): K3 then reads
the valid length from the device over a grid the cache's capacity sets,
and the dot path masks by it as by an int.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.scope import named_scope
from repro_torch.kernels.decode_attention import HEAD_DIMS as K3_HEAD_DIMS
from repro_torch.sharding.plan import per_shard

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


def _cast_bytes(*ts) -> int:
    """Bytes read and written by casting ``ts`` to float32 (none if they
    are float32): numel x (itemsize + 4); a quantized cache's first cast."""
    return sum(t.numel() * (t.element_size() + 4) for t in ts if t.dtype != torch.float32)


def attention_dot(q, k, v, **kw):
    with named_scope("attention_core") as sp:
        if sp.recording:
            sp.note(cast_bytes=_cast_bytes(k, v))
        return _attention_dot(q, k, v, **kw)


def _attention_dot(q, k, v, *, causal=True, window=None, q_offset=0,
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


def attention_chunked(q, k, v, **kw):
    with named_scope("attention_core") as sp:
        if sp.recording:
            sp.note(cast_bytes=_cast_bytes(k, v))
        return _attention_chunked(q, k, v, **kw)


def _attention_chunked(q, k, v, *, causal=True, window=None, q_offset=0,
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


def _keys_cut(q, k) -> tuple:
    """The mesh dims that cut k's key axis (dim 1) while q's is whole: the
    flash-decode layout of a decode cache sharded on its sequence."""
    from torch.distributed.tensor import DTensor
    if not (isinstance(q, DTensor) and isinstance(k, DTensor)) or any(
            p.is_shard(1) for p in q.placements):
        return ()
    return tuple(i for i, p in enumerate(k.placements) if p.is_shard(1))


def _attention_keys_cut(q, k, v, dims, *, causal, window, q_offset, kv_valid_len,
                        k_scale, v_scale, softmax_scale):
    """Dot attention over keys cut on mesh ``dims``, as XLA partitions
    ``repro.models.attention``'s softmax over a sharded key axis: each shard
    scores its own keys (at their global positions), the row max and the
    row sum are all-reduced over ``dims``, and so is P·V.  q's heads and
    batch keep their cuts; the other inputs follow k's."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    mesh = k.device_mesh
    q_pl = tuple(Replicate() if i in dims else p for i, p in enumerate(q.placements))
    k_pl = k.placements
    s_pl = tuple(p if i in dims else q_pl[i] for i, p in enumerate(k_pl))
    kv_pl = s_pl
    off = compute_local_shape_and_global_offset(k.shape, mesh, kv_pl)[1][1]

    def reduce(t, op):
        for i in dims:
            t = funcol.all_reduce(t, op, (mesh, i))
        return t

    def local(q, k, v, k_scale, v_scale):
        B, Sq, H, hd = q.shape
        K = k.shape[2]
        G = H // K
        scale = softmax_scale if softmax_scale is not None else hd ** -0.5
        k = _dequant(k, k_scale).to(q.dtype)
        v = _dequant(v, v_scale).to(q.dtype)
        scores = _gqa_scores(q.reshape(B, Sq, K, G, hd), k) * scale    # [B,K,G,Sq,Sk]
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        k_pos = off + torch.arange(k.shape[1], device=q.device)
        m = _mask(q_pos, k_pos, causal=causal, window=window, kv_valid_len=kv_valid_len)
        scores = torch.where(m[None, None, None], scores, NEG_INF)
        row_max = reduce(torch.amax(scores, dim=-1, keepdim=True), "max")
        p = torch.exp(scores - row_max)
        row_sum = reduce(torch.sum(p, dim=-1, keepdim=True), "sum")
        probs = p / row_sum
        out = reduce(torch.einsum("bkgqs,bskd->bqkgd", probs.to(q.dtype).float(), v.float()),
                     "sum")
        return out.reshape(B, Sq, H, hd).to(q.dtype)

    scale_pl = None if k_scale is None else kv_pl
    with named_scope("attention_core"):
        return per_shard(local, (q_pl, kv_pl, kv_pl, scale_pl, scale_pl), q_pl)(
            q, k, v, k_scale, v_scale)


def _shardwise(q, k, v, k_scale, v_scale) -> bool:
    """Can a call on DTensors run shard by shard?  Yes when q, k and v are
    DTensors cut alike on batch (dim 0) and heads (dim 2) only (each shard's
    q heads meet their own kv heads), and the scales, if any, likewise."""
    from torch.distributed.tensor import DTensor
    if not isinstance(q, DTensor):
        return False
    pl = q.placements
    if not all(p.is_replicate() or (p.is_shard() and p.dim in (0, 2)) for p in pl):
        return False
    return all(isinstance(t, DTensor) and t.placements == pl
               for t in (k, v) + tuple(t for t in (k_scale, v_scale) if t is not None))


def _key_range(k, *, causal, window, q_offset, kv_valid_len) -> tuple:
    """(lo, hi): the keys that one query row at ``q_offset`` attends to under
    ``_mask`` (the valid length, the causal limit and an int window)."""
    hi = k.shape[1]
    if kv_valid_len is not None:
        hi = min(hi, kv_valid_len)
    if causal:
        hi = min(hi, q_offset + 1)
    lo = max(0, q_offset - window + 1) if window is not None and window > 0 else 0
    return lo, hi


def _device_length(q, causal, window, q_offset, kv_valid_len) -> bool:
    """Does the call give its positions as a device tensor that K3 takes:
    the valid length one int64 on q's device, with no causal limit and no
    window to fold into the key range?"""
    return (torch.is_tensor(kv_valid_len) and kv_valid_len.dtype == torch.int64
            and kv_valid_len.numel() == 1 and kv_valid_len.device == q.device
            and not causal and (window is None or window <= 0))


def k3_refusal(q, k, v, *, impl, causal=True, window=None, q_offset=0, kv_valid_len=None,
               k_scale=None, v_scale=None) -> str | None:
    """Why K3 does not take this attention call, or None when it does.  A
    rule on the inputs alone: the "dot" impl, one query row, plain tensors
    (not DTensors) on a CUDA card, k and v of q's type (bf16 or f16) with no
    scales, an int or no window, a head dim that K3 instantiates, int
    positions that leave some key or a device length (``_device_length``),
    and no gradient wanted."""
    if impl != "dot":
        return "impl"
    if q.dim() != 4 or q.shape[1] != 1:
        return "more than one query row"
    if not all(type(t) is torch.Tensor for t in (q, k, v)):
        return "a DTensor or another tensor subclass"
    if k_scale is not None or v_scale is not None:
        return "a quantized cache"
    if q.dtype not in (torch.bfloat16, torch.float16) or not q.dtype == k.dtype == v.dtype:
        return "dtype"
    if window is not None and not isinstance(window, int):
        return "a tensor window"
    if q.shape[3] not in K3_HEAD_DIMS:
        return "head_dim"
    if not _device_length(q, causal, window, q_offset, kv_valid_len):
        if not isinstance(q_offset, int) or not isinstance(kv_valid_len, (int, type(None))):
            return "a tensor position"
        lo, hi = _key_range(k, causal=causal, window=window, q_offset=q_offset,
                            kv_valid_len=kv_valid_len)
        if hi <= lo:
            return "no key"
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return "a gradient"
    if not _on_card(q, k, v):
        return "not on a CUDA card"
    return None


def _on_card(q, k, v) -> bool:
    return q.is_cuda and k.is_cuda and v.is_cuda


def attention_decode(q, k, v, *, causal=True, window=None, q_offset=0, kv_valid_len=None,
                     softmax_scale=None):
    """One query row through K3, over the keys ``_key_range`` gives, or
    over the keys below a device length, on the grid of the whole cache."""
    from repro_torch.kernels import ops as kops
    valid = None
    if torch.is_tensor(kv_valid_len):
        lo, hi, valid = 0, k.shape[1], kv_valid_len
    else:
        lo, hi = _key_range(k, causal=causal, window=window, q_offset=q_offset,
                            kv_valid_len=kv_valid_len)
    with named_scope("attention_core") as sp:
        if sp.recording:
            sp.note(cast_bytes=0)
        return kops.decode_attention(q, k, v, lo=lo, hi=hi, softmax_scale=softmax_scale,
                                     valid=valid)


def attention(q, k, v, *, impl="auto", causal=True, window=None, q_offset=0,
              kv_valid_len=None, k_scale=None, v_scale=None, chunk=1024,
              softmax_scale=None):
    """Attention by ``impl``.  On DTensors cut alike on batch and heads it
    runs on each shard's local tensors, as under JAX's shard_map (attention
    is independent per batch row and head); the dot path over a key axis
    cut on the mesh (a decode cache sharded on its sequence) runs per shard
    with its softmax's row max and sum all-reduced
    (``_attention_keys_cut``); other DTensors take the ops one by one
    through DTensor.  A "dot" call that ``k3_refusal`` finds nothing against
    goes to K3 (the shard-wise path keeps the dot path)."""
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_valid_len=kv_valid_len, k_scale=k_scale, v_scale=v_scale,
              softmax_scale=softmax_scale)
    if _shardwise(q, k, v, k_scale, v_scale):
        def local(q, k, v, k_scale, v_scale):
            return _by_impl(q, k, v, impl=impl, chunk=chunk, decode_kernel=False,
                            **dict(kw, k_scale=k_scale, v_scale=v_scale))
        pl = q.placements
        return per_shard(local, (pl,) * 5, pl)(q, k, v, k_scale, v_scale)
    dims = _keys_cut(q, k)
    if dims and impl == "dot":
        return _attention_keys_cut(q, k, v, dims, **kw)
    return _by_impl(q, k, v, impl=impl, chunk=chunk, decode_kernel=True, **kw)


def _by_impl(q, k, v, *, impl, chunk, decode_kernel, causal, window, q_offset, kv_valid_len,
             k_scale, v_scale, softmax_scale):
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_valid_len=kv_valid_len, k_scale=k_scale, v_scale=v_scale,
              softmax_scale=softmax_scale)
    if impl == "auto":
        impl = "chunked" if (q.shape[1] > 2048 or k.shape[1] > 4096) else "dot"
    if impl == "dot":
        if decode_kernel and k3_refusal(
                q, k, v, impl=impl, causal=causal, window=window, q_offset=q_offset,
                kv_valid_len=kv_valid_len, k_scale=k_scale, v_scale=v_scale) is None:
            return attention_decode(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                    kv_valid_len=kv_valid_len, softmax_scale=softmax_scale)
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
