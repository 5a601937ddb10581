"""K4: the Mamba-2 prefill's depthwise causal conv and its SiLU, a CUDA C++
kernel for Hopper, and its plain version.

Layout: up to three tensors x [B, S, C] (a Mamba-2 layer's x, B and C,
each of its own width C), each with weights w [W, C] and a bias b [C];
outputs silu(causal_conv(x, w, b)) [B, S, C] in x's type.  The kernel
(``csrc/causal_conv.cu``) replaces no TPU kernel: the JAX package computes
the conv with jnp (``repro.models.ssm.causal_conv``) and leaves its passes
to XLA.  It reads each input row once and writes each output row once, for
all three tensors in one launch, with the products, the sums and the SiLU
in f32, rounded once to bf16; the plain version, the eager passes it
replaces, rounds to bf16 after every product and sum.

``causal_conv_silu`` runs the plain version for tensors on the CPU, and
launches the kernel for CUDA tensors or raises on what it does not take
(bf16 x, w and b, W <= 4, C a multiple of 8, contiguous and 16-byte
aligned); there is no fallback.  Every other tensor (on the meta device, a
fake tensor) goes through the custom op ``repro_torch::causal_conv_silu``,
whose fake function gives empty outputs; its operations and bytes
(``work``) are what ``analysis.account`` counts for a call.  K4 has no
backward: a call that needs a gradient raises (the model keeps its training
path on the plain version, ``models/ssm.py::k4_refusal``).
"""
from __future__ import annotations

import ctypes
from typing import List

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

MAX_WIDTH = 4
MAX_PARTS = 3
VEC = 8                   # channels a thread owns: one 16-byte vector


def causal_conv_plain(x, w, b, halo=None):
    """Depthwise causal conv, the eager passes: x [B,S,C]; w [W,C]; b [C];
    ``halo`` [B,W-1,C] the rows before x (zeros if None).  The pad, then W
    shifted products and sums and the bias, each in the promoted type."""
    W, S = w.shape[0], x.shape[1]
    xp = torch.cat([halo.to(x.dtype), x], dim=1) if halo is not None else F.pad(x, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def causal_conv_silu_plain(x, w, b):
    """The plain PyTorch version of K4 for one tensor: ``causal_conv_plain``,
    then the SiLU through float32, in x's type."""
    return F.silu(causal_conv_plain(x, w, b).float()).to(x.dtype)


def work(shape, W, itemsize=2):
    """(flops, bytes) of one K4 call over rows [B, S] of C channels (all its
    tensors' together): W multiply-adds and the bias a value; each input
    and output value once, and the W weights and the bias once a channel."""
    B, S, C = shape
    rows = B * S
    return rows * C * (2 * W + 1), (2 * rows * C + (W + 1) * C) * itemsize


def _check(parts):
    if not 1 <= len(parts) <= MAX_PARTS:
        raise ValueError(f"K4 takes 1 to {MAX_PARTS} tensors, got {len(parts)}")
    xs, ws, bs = (list(t) for t in zip(*parts))
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in xs + ws + bs):
        raise ValueError("K4 takes plain tensors, not DTensors")
    if any(x.dim() != 3 or w.dim() != 2 or b.dim() != 1 for x, w, b in parts):
        raise ValueError("causal_conv_silu wants x [B,S,C], w [W,C], b [C]")
    B, S, W = *xs[0].shape[:2], ws[0].shape[0]
    for x, w, b in parts:
        C = x.shape[2]
        if (tuple(x.shape[:2]), tuple(w.shape), tuple(b.shape)) != ((B, S), (W, C), (C,)):
            raise ValueError(f"shape mismatch: x {tuple(x.shape)} w {tuple(w.shape)} "
                             f"b {tuple(b.shape)} (B, S and W shared)")
    if any(t.device != xs[0].device for t in xs + ws + bs):
        raise ValueError("x, w and b must be on one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in xs + ws + bs):
        raise RuntimeError("K4 (the causal conv and SiLU) has no backward")
    return xs, ws, bs


def causal_conv_silu(parts):
    """``parts``: 1 to 3 (x [B,S,C], w [W,C], b [C]) sharing B, S and W ->
    [silu(causal_conv(x, w, b)) [B,S,C] in x's type].

    CPU tensors take the plain version; CUDA tensors launch K4 on the
    current stream, one launch for all the parts (counted in
    ``causal_conv_silu.launches``), or raise on what it does not take."""
    xs, ws, bs = _check(parts)
    if xs[0].device.type == "cpu":
        return [causal_conv_silu_plain(x, w, b) for x, w, b in parts]
    return list(torch.ops.repro_torch.causal_conv_silu(xs, ws, bs))


@torch.library.custom_op("repro_torch::causal_conv_silu", mutates_args=())
def _conv_op(xs: List[torch.Tensor], ws: List[torch.Tensor],
             bs: List[torch.Tensor]) -> List[torch.Tensor]:
    """K4 as an op: CUDA tensors launch the kernel."""
    return _launch(xs, ws, bs)


@_conv_op.register_fake
def _conv_fake(xs, ws, bs):
    return [torch.empty_like(x) for x in xs]


def _lib():
    fn = build.load("causal_conv").repro_causal_conv_silu
    if fn.argtypes is None:
        # x, w, b, y (arrays of pointers), channels; n_parts, B, S, W; stream
        fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p)] * 4 + [ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(xs, ws, bs):
    """Launch K4 on checked CUDA tensors."""
    x0 = xs[0]
    if x0.device.type != "cuda":
        raise ValueError(f"no K4 kernel for device {x0.device}")
    tensors = xs + ws + bs
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError("K4 takes bfloat16 x, w and b, got "
                         f"{sorted({str(t.dtype) for t in tensors})}")
    B, S = x0.shape[:2]
    W = ws[0].shape[0]
    if not 1 <= W <= MAX_WIDTH:
        raise ValueError(f"K4 takes a conv width of 1 to {MAX_WIDTH}, got {W}")
    if any(x.shape[2] % VEC for x in xs):
        raise ValueError(f"K4 takes channels in multiples of {VEC}, got "
                         f"{[x.shape[2] for x in xs]}")
    if any(t.numel() == 0 for t in tensors):
        raise ValueError("K4 wants at least one row and channel")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K4 wants contiguous x, w and b")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("K4 wants x, w and b 16-byte aligned")
    if B > 2**31 - 1 or S > 2**31 - 1:
        raise ValueError(f"K4 takes B and S below 2^31, got {B}, {S}")
    ys = [torch.empty_like(x) for x in xs]
    n = len(xs)

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    with torch.cuda.device(x0.device):
        err = _lib()(ptrs(xs), ptrs(ws), ptrs(bs), ptrs(ys),
                     (ctypes.c_int * n)(*(x.shape[2] for x in xs)), n, B, S, W, stream)
    if err != 0:
        raise RuntimeError(f"K4 causal conv and SiLU launch failed: CUDA error {err}")
    causal_conv_silu.launches += 1
    return ys


causal_conv_silu.launches = 0
