"""Pieces both plain references share: float32 set-up, the norm and the
matrix product, which the control can compute with float8 operands."""
from __future__ import annotations

import torch

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def full_precision():
    """Float32 products in float32: no TF32 in matrix products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def f32(t):
    return t.to(torch.float32)


def rms_norm(x, w, eps):
    """RMSNorm with the weight stored as an offset from 1 (the model's
    convention): x / rms(x) * (1 + w)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + f32(w))


def _fp8(t, dim):
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``."""
    scale = torch.clamp(torch.amax(torch.abs(t), dim=dim, keepdim=True), min=1e-12) / FP8_MAX
    return (t / scale).to(FP8).to(torch.float32) * scale


def matmul(a, w, fp8=False):
    """a [..., k] float32 times the weight w [k, n] (any type) in float32.
    With ``fp8`` both operands are first rounded to float8 e4m3, a by rows
    and w by output columns, as a float8 serving path would compute."""
    w = f32(w)
    if fp8:
        a, w = _fp8(a, -1), _fp8(w, 0)
    return a @ w
