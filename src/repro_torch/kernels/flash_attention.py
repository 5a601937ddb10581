"""K1: flash attention, a CUDA C++ kernel for Hopper, and its plain version.

Layout: q [B, H, Sq, hd]; k, v [B, K, Skv, hd]; out [B, H, Sq, hd].  The
kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel of
``repro.kernels.flash_attention``: online softmax with fp32 running max,
sum and accumulator, GQA by index, causal / sliding-window / kv_valid masks
fused, fully masked kv tiles skipped.  It has three variants: bf16 at head
dim 64 or 128 runs on Hopper's warpgroup MMA, fed by TMA ("wg"); bf16 at
any other head dim that is a multiple of 16 on the tensor cores through
warp-level ``mma.sync`` ("tc"); every other call on CUDA cores in fp32
("fma").  ``k1_variant`` chooses.

``flash_attention_hmajor`` launches the kernel for CUDA tensors and runs
the plain version only for tensors on the CPU.  Every other tensor (on the
meta device, a fake tensor, a DTensor) goes through the custom op
``repro_torch::flash_attention_hmajor``: its fake function gives an empty
output of q's shape and type and computes nothing.  (On a mesh the model
calls it on each shard's local tensors, models/attention.py.)  Its
operations and bytes (``work``) are what ``analysis.account`` counts for a
call.  K1 has no backward, as the
JAX package's Pallas kernel has none (``jax.grad`` through it fails), so a
call under autograd raises, on the CPU too: training takes the "dot",
"chunked" or "auto" attention paths, as the JAX package's does.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODES = {"fma": 0, "tc": 1, "wg": 2}
MAX_HEAD_DIM = 256
WG_HEAD_DIMS = (64, 128)


def _takes(variant, dtype, hd):
    """Whether ``variant`` of K1 can compute a call on ``dtype`` at head dim ``hd``."""
    if variant == "wg":
        return dtype == torch.bfloat16 and hd in WG_HEAD_DIMS
    if variant == "tc":
        return dtype == torch.bfloat16 and hd % 16 == 0 and hd <= MAX_HEAD_DIM
    return variant == "fma"


def k1_variant(dtype, hd):
    """"wg" (bf16 wgmma kernel) for bfloat16 at hd 64 or 128; "tc" (bf16
    mma.sync kernel) for bfloat16 at any other hd % 16 == 0, hd <= 256; "fma"
    (fp32 CUDA-core kernel) for everything else, f32 included."""
    return next(v for v in ("wg", "tc", "fma") if _takes(v, dtype, hd))


def _lib():
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        # q, k, v, o; dtype, variant, B, H, K, Sq, Skv, hd, causal, window,
        # kv_valid; scale; stream
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_hmajor wants q [B,H,Sq,hd], k/v [B,K,Skv,hd]")
    B, H, Sq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if H % k.shape[1] != 0:
        raise ValueError(f"q heads {H} not a multiple of kv heads {k.shape[1]}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: want all "
                         "float32 or all bfloat16")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def _refuse_autograd(q, k, v):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("K1 (flash attention) has no backward: train with attention_impl "
                           "'dot', 'chunked' or 'auto', as the JAX package does")


def flash_attention_hmajor_plain(q, k, v, *, causal=True, window=0,
                                 kv_valid=None, softmax_scale=None):
    """The plain PyTorch version of K1 (the semantics of ``attention_ref``)."""
    return attention_ref(q, k, v, causal=causal, window=window,
                         kv_valid=kv_valid, softmax_scale=softmax_scale)


def flash_attention_hmajor(q, k, v, *, causal=True, window=0, kv_valid=None,
                           softmax_scale=None):
    """q [B,H,Sq,hd]; k,v [B,K,Skv,hd] -> [B,H,Sq,hd].

    window: 0/negative = global.  kv_valid: #valid kv positions (default Skv).
    CPU tensors take the plain version; CUDA tensors launch the kernel variant
    that ``k1_variant`` chooses on the current stream (one launch, counted in
    ``flash_attention_hmajor.launches`` and, by variant, in
    ``.launches_by_variant``).
    """
    _check(q, k, v)
    _refuse_autograd(q, k, v)
    if type(q) is torch.Tensor and q.device.type == "cpu":
        return flash_attention_hmajor_plain(q, k, v, causal=causal, window=window,
                                            kv_valid=kv_valid,
                                            softmax_scale=softmax_scale)
    window = int(window) if window and window > 0 else 0
    return torch.ops.repro_torch.flash_attention_hmajor(
        q, k, v, bool(causal), window, None if kv_valid is None else int(kv_valid),
        None if softmax_scale is None else float(softmax_scale))


@torch.library.custom_op("repro_torch::flash_attention_hmajor", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
              kv_valid: Optional[int], softmax_scale: Optional[float]) -> torch.Tensor:
    """K1 as an op: a CUDA tensor launches the kernel, a CPU tensor (a
    DTensor's shard on a CPU mesh) runs the plain version."""
    if q.device.type == "cpu":
        return flash_attention_hmajor_plain(q, k, v, causal=causal, window=window,
                                            kv_valid=kv_valid, softmax_scale=softmax_scale)
    return _launch(q, k, v, k1_variant(q.dtype, q.shape[3]), causal=causal, window=window,
                   kv_valid=kv_valid, softmax_scale=softmax_scale)


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, window, kv_valid, softmax_scale):
    return torch.empty_like(q)


def work(q_shape, kv_len, causal=True, window=0, itemsize=2):
    """(flops, bytes) of one K1 call on q [B,H,Sq,hd] over ``kv_len`` keys
    and values of K heads (``kv_len`` = (K, Skv)): q.k and p.v over the
    (q, k) pairs the mask keeps (the causal half where Sq == Skv, fewer
    under a sliding window), 2 flops per MAC; q, k, v read and the output
    written once."""
    B, H, Sq, hd = q_shape
    K, Skv = kv_len
    if causal and window and window > 0:
        w = min(window, Sq)
        pairs = w * (w + 1) // 2 + (Sq - w) * w
    elif causal:
        pairs = Sq * (Sq + 1) // 2
    else:
        pairs = Sq * Skv
    nbytes = itemsize * (2 * B * H * Sq * hd + 2 * B * K * Skv * hd)
    return 4 * hd * pairs * B * H, nbytes


def _launch(q, k, v, variant, *, causal, window, kv_valid, softmax_scale):
    """Launch ``variant`` ("wg", "tc" or "fma") of K1 on checked CUDA tensors.
    The serve path takes ``k1_variant``'s choice; tests/test_torch_kernels_card.py
    also holds "tc" where "wg" serves through here.  A variant that cannot
    take the call raises."""
    if variant not in _VARIANT_CODES or not _takes(variant, q.dtype, q.shape[3]):
        raise ValueError(f"K1 variant {variant!r} does not take {q.dtype} at "
                         f"head_dim {q.shape[3]}")
    _refuse_autograd(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("K1 wants contiguous head-major q, k and v")
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"K1 takes head_dim <= {MAX_HEAD_DIM}, got {hd}")
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    kv_valid = Skv if kv_valid is None else min(int(kv_valid), Skv)
    window = int(window) if window and window > 0 else 0
    if variant != "fma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"K1's tensor-core kernel ({variant}) wants q, k and v "
                         "16-byte aligned")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     _DTYPE_CODES[q.dtype], _VARIANT_CODES[variant], B, H, K, Sq, Skv,
                     hd, int(causal), window, max(kv_valid, 0), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"K1 flash attention ({variant}) launch failed: CUDA error {err}")
    flash_attention_hmajor.launches += 1
    flash_attention_hmajor.launches_by_variant[variant] += 1
    return out


def occupancy(variant, hd):
    """(dynamic shared memory in bytes, blocks per SM) of the kernel that
    ``variant`` launches at head dim ``hd``, on the current CUDA device."""
    fn = build.load("flash_attention").repro_flash_attention_occupancy
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(_VARIANT_CODES[variant], int(hd), ctypes.byref(smem), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"K1 occupancy query ({variant}, hd {hd}) failed: CUDA error {err}")
    return smem.value, blocks.value


flash_attention_hmajor.launches = 0
flash_attention_hmajor.launches_by_variant = {"wg": 0, "tc": 0, "fma": 0}
