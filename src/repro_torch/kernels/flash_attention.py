"""K1: flash attention, a CUDA C++ kernel for Hopper, and its plain version.

Layout: q [B, H, Sq, hd]; k, v [B, K, Skv, hd]; out [B, H, Sq, hd].  The
kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel of
``repro.kernels.flash_attention``: online softmax with fp32 running max,
sum and accumulator, GQA by index, causal / sliding-window / kv_valid masks
fused, fully masked kv tiles skipped.  It has two variants: bf16 at a head
dim that is a multiple of 16 runs on the tensor cores ("tc"), every other
call on CUDA cores in fp32 ("fma"); ``k1_variant`` chooses.

``flash_attention_hmajor`` launches the kernel for CUDA tensors and runs
the plain version only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODES = {"fma": 0, "tc": 1}
MAX_HEAD_DIM = 256


def k1_variant(dtype, hd):
    """"tc" (bf16 tensor-core kernel) for bfloat16 at hd % 16 == 0, hd <= 256;
    "fma" (fp32 CUDA-core kernel) for everything else, f32 included."""
    return "tc" if dtype == torch.bfloat16 and hd % 16 == 0 and hd <= MAX_HEAD_DIM else "fma"


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
    if q.device.type == "cpu":
        return flash_attention_hmajor_plain(q, k, v, causal=causal, window=window,
                                            kv_valid=kv_valid,
                                            softmax_scale=softmax_scale)
    return _launch(q, k, v, k1_variant(q.dtype, q.shape[3]), causal=causal, window=window,
                   kv_valid=kv_valid, softmax_scale=softmax_scale)


def _launch(q, k, v, variant, *, causal, window, kv_valid, softmax_scale):
    """Launch ``variant`` ("tc" or "fma") of K1 on checked CUDA tensors.  The
    serve path takes ``k1_variant``'s choice; chip_smoke.py also times the
    "fma" kernel on bf16 inputs through here.  A variant that cannot take
    the call raises."""
    if variant not in _VARIANT_CODES or (variant == "tc" and
                                         k1_variant(q.dtype, q.shape[3]) != "tc"):
        raise ValueError(f"K1 variant {variant!r} does not take {q.dtype} at "
                         f"head_dim {q.shape[3]}")
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
    if variant == "tc" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("K1's tensor-core kernel wants q, k and v 16-byte aligned")
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
flash_attention_hmajor.launches_by_variant = {"tc": 0, "fma": 0}
