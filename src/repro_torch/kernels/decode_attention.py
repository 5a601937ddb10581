"""K3: decode attention split over keys, a CUDA C++ kernel for Hopper, and its plain version.

One query row (Sq = 1) against the KV cache in the model's layout: q
[B, 1, H, hd]; k, v [B, S, K, hd], read through their strides; keys ``lo``
to ``hi - 1`` only (``models/attention.py`` folds the valid length, the
causal limit and the sliding window into that range).  The kernel
(``csrc/decode_attention.cu``) replaces no TPU kernel: the JAX package
computes decode attention with einsums.  It reads the bf16 (or f16) cache
once, in place, split over the keys as FlashDecoding splits it: one block
per (key split, kv head, batch row) keeps a running max, sum and f32
accumulator for the query heads of its kv head; a second, small launch
combines the splits (none when there is one split).  ``k3_splits`` picks
the split count from B * K and the range's length: as many splits as fill
the card's resident blocks once.

Where the position lives on the device (a decode step replayed as a CUDA
graph, ``models/decode_graph.py``), ``valid`` is an int64 tensor of one
element holding the end of the keys: the call reads keys ``lo`` to
``min(hi, valid) - 1``, over the grid that ``lo .. hi - 1`` (the cache's
capacity) sets, so the launch's shape does not change from step to step.
Splits past the valid length exit at once and the combine skips them.

``decode_attention`` launches the kernel for CUDA tensors and runs the
plain version, the same algorithm in PyTorch, for tensors on the CPU.  It
counts its kernel launches in ``decode_attention.launches`` (by kernel in
``.launches_by_variant``: "split", and "combine" where there are several
splits).  K3 has no backward: a call that needs a gradient raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (16, 32, 64, 128, 256)
HEADS_PER_BLOCK = (1, 2, 4, 8)
# blocks of the split kernel resident on an SM, by query heads a block
# (``occupancy`` reads them on the card)
BLOCKS_PER_SM = {1: 2, 2: 2, 4: 2, 8: 1}
MIN_SPLIT_KEYS = 256
SMS_H100 = 132


def heads_per_block(G: int) -> int:
    """Query heads of one kv head that a block holds: G rounded up to a power
    of two, at most 8 (a larger G takes several blocks per kv head)."""
    return next(gt for gt in HEADS_PER_BLOCK if gt >= min(G, 8))


def k3_splits(blocks_per_split: int, n_keys: int, sms: int = SMS_H100,
              blocks_per_sm: int = 2) -> tuple[int, int]:
    """(splits, keys per split) for ``n_keys`` keys, where one split takes
    ``blocks_per_split`` blocks (B x K x head chunks): as many splits as
    fill the card's resident blocks (``blocks_per_sm`` on each of ``sms``)
    once, none shorter than ``MIN_SPLIT_KEYS`` (unless the range is), the
    last one ragged and none empty.  Longer splits beat more of them: each
    block pays a prologue and a combine."""
    splits = max(1, min(blocks_per_sm * sms // blocks_per_split, n_keys // MIN_SPLIT_KEYS))
    chunk = -(-n_keys // splits)
    return -(-n_keys // chunk), chunk


def _split(B, H, K, n, sms=SMS_H100):
    """(heads a block, splits, keys per split) of a call."""
    gt = heads_per_block(H // K)
    return (gt, *k3_splits(B * K * -(-(H // K) // gt), n, sms, BLOCKS_PER_SM[gt]))


def kv_bytes(k, lo: int, hi: int) -> int:
    """Bytes of k and v in keys lo .. hi-1: what K3 reads of the cache."""
    B, _, K, hd = k.shape
    return 2 * B * (hi - lo) * K * hd * k.element_size()


def key_end(lo: int, hi: int, valid) -> int:
    """The end of the keys a call reads: ``hi``, or the valid length that the
    tensor ``valid`` holds, kept within lo .. hi (read by the host)."""
    return hi if valid is None else max(lo, min(hi, int(valid)))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib():
    fn = build.load("decode_attention").repro_decode_attention
    if fn.argtypes is None:
        # q, k, v, out, part_o, part_ml, valid; dtype, B, H, K, hd, gt, lo, hi,
        # chunk, splits; strides; scale; stream
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, lo, hi, valid=None):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or q.shape[1] != 1:
        raise ValueError("decode_attention wants q [B,1,H,hd], k/v [B,S,K,hd]")
    B, _, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if H % k.shape[2] != 0:
        raise ValueError(f"q heads {H} not a multiple of kv heads {k.shape[2]}")
    if not 0 <= lo < hi <= k.shape[1]:
        raise ValueError(f"key range {lo}..{hi} not inside 0..{k.shape[1]}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if valid is not None and (valid.dtype != torch.int64 or valid.numel() != 1
                              or valid.device != q.device):
        raise ValueError("valid must be one int64 on q's device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("K3 (decode attention) has no backward")


def decode_attention_plain(q, k, v, *, lo, hi, softmax_scale=None, splits=None, valid=None):
    """The plain PyTorch version of K3: the keys lo .. hi-1 cut into
    ``splits`` splits (``k3_splits``'s by default), each split's scores
    (f32 products of q and k, times the scale in f32), max ``m``, sum ``l``
    of exp(s - m) and P V with exp(s - m) rounded to the cache's type, all
    in f32; then the splits combined, weighted by exp(m - max m).  With
    ``valid``, the keys past its value are left out: the splits that start
    there are skipped, the one it cuts is cut short."""
    B, _, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    n = hi - lo
    if splits is None:
        _, splits, chunk = _split(B, H, K, n)
    else:
        chunk = -(-n // splits)
    end = key_end(lo, hi, valid)
    if end == lo:                                        # no key: the kernel writes zeros
        return torch.zeros_like(q)
    qg = q.reshape(B, K, G, hd).float()
    ms, ls, accs = [], [], []
    for a in range(lo, end, chunk):
        k_s, v_s = k[:, a:min(end, a + chunk)], v[:, a:min(end, a + chunk)]
        s = torch.einsum("bkgd,bskd->bkgs", qg, k_s.float()) * scale
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v_s.float()))
    m = torch.stack(ms)                                  # [splits, B, K, G]
    w = torch.exp(m - m.amax(dim=0))
    l_sum = (w * torch.stack(ls)).sum(dim=0)
    acc = (w[..., None] * torch.stack(accs)).sum(dim=0)
    out = acc / torch.clamp(l_sum, min=1e-30)[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention(q, k, v, *, lo, hi, softmax_scale=None, valid=None):
    """q [B,1,H,hd]; k, v [B,S,K,hd] -> [B,1,H,hd] over keys lo .. hi-1, or
    with ``valid`` (one int64 on q's device) over keys lo .. min(hi, valid)-1
    on the grid of lo .. hi-1.

    CPU tensors take the plain version; CUDA tensors launch K3 on the
    current stream (one or two launches, counted), or raise on what it does
    not take."""
    _check(q, k, v, lo, hi, valid)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lo=lo, hi=hi, softmax_scale=softmax_scale,
                                      valid=valid)
    return _launch(q, k, v, lo=lo, hi=hi, softmax_scale=softmax_scale, valid=valid)


def _launch(q, k, v, *, lo, hi, softmax_scale=None, splits=None, valid=None):
    """Launch K3 on checked CUDA tensors, with ``k3_splits``'s split count
    or ``splits`` (chip_smoke.py times other counts through here), and the
    device's valid length ``valid`` or none."""
    if q.device.type != "cuda":
        raise ValueError(f"no K3 kernel for device {q.device}")
    if type(q) is not torch.Tensor or type(k) is not torch.Tensor or type(v) is not torch.Tensor:
        raise ValueError("K3 takes plain tensors, not DTensors or other subclasses")
    B, _, H, hd = q.shape
    K = k.shape[2]
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"K3 takes q, k and v all bfloat16 or all float16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"K3 takes head_dim in {HEAD_DIMS}, got {hd}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("K3 wants the head dim of q, k and v contiguous")
    strides = [q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
               v.stride(0), v.stride(1), v.stride(2)]
    if any(s % 8 for s in strides) or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("K3 wants 16-byte aligned rows of q, k and v")
    n = hi - lo
    gt, auto_splits, chunk = _split(B, H, K, n, _sms(q.device.index or 0))
    if splits is None:
        splits = auto_splits
    else:
        chunk = -(-n // splits)
        splits = -(-n // chunk)
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    part = (torch.empty(B * H * splits * (hd + 2), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    part_o = 0 if part is None else part.data_ptr()
    part_ml = 0 if part is None else part.data_ptr() + 4 * B * H * splits * hd
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), part_o, part_ml,
                     0 if valid is None else valid.data_ptr(),
                     _DTYPE_CODES[q.dtype], B, H, K, hd, gt, lo, hi, chunk, splits,
                     (ctypes.c_longlong * 8)(*strides), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"K3 decode attention launch failed: CUDA error {err}")
    decode_attention.launches_by_variant["split"] += 1
    decode_attention.launches += 1
    if splits > 1:
        decode_attention.launches_by_variant["combine"] += 1
        decode_attention.launches += 1
    return out


def occupancy(hd: int, gt: int) -> int:
    """Blocks of K3's split kernel (bf16, head dim ``hd``, ``gt`` query heads
    a block) that fit on an SM of the current CUDA device."""
    fn = build.load("decode_attention").repro_decode_attention_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    err = fn(int(hd), int(gt), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"K3 occupancy query (hd {hd}, {gt} heads) failed: CUDA error {err}")
    return blocks.value


decode_attention.launches = 0
decode_attention.launches_by_variant = {"split": 0, "combine": 0}
