"""K2: the Mamba-2 SSD chunked scan, a CUDA C++ kernel for Hopper, and its
plain version.

Layout (head-major): x [B, H, S, P]; dt [B, H, S]; A [H];
B_in/C_in [B, G, S, N]; outputs y [B, H, S, P] in x's type and the final
state [B, H, P, N] in fp32.  The kernel (``csrc/ssd_scan.cu``) replaces the
Pallas TPU kernel of ``repro.kernels.ssd_scan``: one block per (b, h)
carries the fp32 state through every chunk of the sequence.  It has two
variants: bf16 x, B and C run on the tensor cores ("tc"), f32 on CUDA cores
in fp32 ("fma"); ``k2_variant`` chooses.

``ssd_scan_hmajor`` launches the kernel for CUDA tensors and runs the plain
version only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

DEFAULT_CHUNK = 256
MAX_HEAD_DIM = 128     # P
MAX_D_STATE = 128      # N

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODES = {"fma": 0, "tc": 1}
# The tc kernel takes att @ x and C @ state^T on tf32 operands: on bf16
# operands the mamba2 serve shape's y, before it is stored in bf16, was off
# by 3.0e-2 on an H100, more than half of the 5e-2 tolerance (PERF.md).
# The bf16-operand kernel stays for chip_smoke.py to measure beside it.
TC_TF32 = True


def k2_variant(x_dtype, P, N):
    """"tc" (bf16 tensor-core kernel) for bfloat16 x, B, C with P, N <= 128
    and multiples of 8 (16-byte rows for its cp.async copies); "fma" (fp32
    CUDA-core kernel) for everything else, f32 included."""
    return ("tc" if x_dtype == torch.bfloat16 and P <= MAX_HEAD_DIM and N <= MAX_D_STATE
            and P % 8 == 0 and N % 8 == 0 else "fma")


def _lib():
    lib = build.load("ssd_scan")
    fn = lib.repro_ssd_scan_fwd
    if fn.argtypes is None:
        # x, dt, A, B, C, h0, y, state; x_dtype, y_dtype, dt_dtype, variant,
        # tf32, B, H, G, S, P, N; stream
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(x, dt, A, B_in, C_in, h0):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B_in.dim() != 4 or C_in.dim() != 4:
        raise ValueError("ssd_scan_hmajor wants x [B,H,S,P], dt [B,H,S], A [H], "
                         "B_in/C_in [B,G,S,N]")
    Bz, H, S, P = x.shape
    G, N = B_in.shape[1], B_in.shape[3]
    if (tuple(dt.shape) != (Bz, H, S) or tuple(A.shape) != (H,)
            or tuple(B_in.shape) != (Bz, G, S, N) or C_in.shape != B_in.shape):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} B {tuple(B_in.shape)} C {tuple(C_in.shape)}")
    if G < 1 or H % G != 0:
        raise ValueError(f"heads {H} not a multiple of B/C groups {G}")
    if S < 1:
        raise ValueError("ssd_scan_hmajor wants at least one position")
    if not (x.dtype == B_in.dtype == C_in.dtype) or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x, B, C dtypes {x.dtype}, {B_in.dtype}, {C_in.dtype}: want "
                         "all float32 or all bfloat16")
    if dt.dtype not in _DTYPE_CODES:
        raise ValueError(f"dt dtype {dt.dtype}: want float32 or bfloat16")
    if A.dtype != torch.float32:
        raise ValueError(f"A dtype {A.dtype}: want float32")
    if h0 is not None and (tuple(h0.shape) != (Bz, H, P, N) or h0.dtype != torch.float32):
        raise ValueError(f"h0 {tuple(h0.shape)} {h0.dtype}: want [B,H,P,N] float32")
    tensors = (x, dt, A, B_in, C_in) + (() if h0 is None else (h0,))
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, dt, A, B, C (and h0) must be on one device")


def ssd_scan_hmajor_plain(x, dt, A, B_in, C_in, *, chunk=DEFAULT_CHUNK, h0=None):
    """The plain PyTorch version of K2: the SSD block decomposition of
    ``repro.models.ssm.ssd_chunked`` in head-major layout.

    The tail is zero-padded to a multiple of ``chunk`` with dt = 0, an exact
    no-op for the outputs at positions < S and for the final state.  Returns
    (y [B,H,S,P] in x's dtype, state [B,H,P,N] fp32).
    """
    Bz, H, S, P = x.shape
    G, N = B_in.shape[1], B_in.shape[3]
    hg = H // G
    pad = (-S) % chunk
    xf = F.pad(x.float(), (0, 0, 0, pad)).reshape(Bz, G, hg, -1, chunk, P)
    dtf = F.pad(dt.float(), (0, pad)).reshape(Bz, G, hg, -1, chunk)
    Bf = F.pad(B_in.float(), (0, 0, 0, pad)).reshape(Bz, G, -1, chunk, N)
    Cf = F.pad(C_in.float(), (0, 0, 0, pad)).reshape(Bz, G, -1, chunk, N)
    nc = xf.shape[3]
    Ar = A.float().reshape(G, hg)[None, :, :, None]                  # [1,G,hg,1]
    h = (torch.zeros((Bz, G, hg, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float().reshape(Bz, G, hg, P, N))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xf[:, :, :, c], dtf[:, :, :, c], Bf[:, :, c], Cf[:, :, c]
        cum = torch.cumsum(dtc * Ar, dim=-1)                         # [b,G,hg,Q]
        total = cum[..., -1]                                         # [b,G,hg]
        # intra-chunk: exp(cum_i - cum_j) overflows for i < j; where() drops it
        CB = torch.einsum("bgin,bgjn->bgij", Cc, Bc)                 # [b,G,Q,Q]
        decay = torch.exp(cum[..., :, None] - cum[..., None, :])     # [b,G,hg,Q,Q]
        att = torch.where(tri, CB[:, :, None] * decay * dtc[..., None, :], 0.0)
        y = torch.einsum("bghij,bghjp->bghip", att, xc)
        # inter-chunk through the carried state
        Ch = torch.einsum("bgqn,bghpn->bghqp", Cc, h)
        y = y + torch.exp(cum)[..., None] * Ch
        # state update
        w = torch.exp(total[..., None] - cum) * dtc                  # [b,G,hg,Q]
        S_c = torch.einsum("bgqn,bghqp->bghpn", Bc, w[..., None] * xc)
        h = h * torch.exp(total)[..., None, None] + S_c
        ys.append(y)
    y = torch.stack(ys, dim=3).reshape(Bz, H, nc * chunk, P)[:, :, :S]
    return y.to(x.dtype), h.reshape(Bz, H, P, N)


def ssd_scan_hmajor(x, dt, A, B_in, C_in, *, chunk=DEFAULT_CHUNK, h0=None):
    """x [B,H,S,P]; dt [B,H,S]; A [H] f32; B_in/C_in [B,G,S,N] -> (y, state).

    x, B_in and C_in share one type (float32 or bfloat16); dt is float32 or
    bfloat16; h0 (optional, [B,H,P,N] float32) is the initial state.  CPU
    tensors take the plain version with chunks of ``chunk`` rows.  CUDA
    tensors launch the kernel variant that ``k2_variant`` chooses on the
    current stream (one launch, counted in ``ssd_scan_hmajor.launches`` and,
    by variant, in ``.launches_by_variant``); the kernel tiles the sequence
    in chunks of its own length (64 rows, so that the [Q,Q] tile fits in
    shared memory) and ignores ``chunk``: the result depends on the chunk
    length only through float rounding.
    """
    _check(x, dt, A, B_in, C_in, h0)
    if x.device.type == "cpu":
        return ssd_scan_hmajor_plain(x, dt, A, B_in, C_in, chunk=chunk, h0=h0)
    return _launch(x, dt, A, B_in, C_in, h0, k2_variant(x.dtype, x.shape[3], B_in.shape[3]),
                   x.dtype)


def _launch(x, dt, A, B_in, C_in, h0, variant, y_dtype, tf32=TC_TF32):
    """Launch ``variant`` ("tc" or "fma") of K2 on checked CUDA tensors, with
    y in ``y_dtype``.  The serve path takes ``k2_variant``'s choice and y in
    x's type; chip_smoke.py also runs the "fma" kernel on bf16 inputs, the
    "tc" kernel with y in float32 (y before it is rounded to bf16) and with
    ``tf32`` off (every product on bf16 operands) through here, to split the
    tensor-core kernel's error by its source.  A variant or y type that
    cannot take the call raises."""
    if variant not in _VARIANT_CODES or (variant == "tc" and k2_variant(
            x.dtype, x.shape[3], B_in.shape[3]) != "tc"):
        raise ValueError(f"K2 variant {variant!r} does not take {x.dtype} at "
                         f"P={x.shape[3]}, N={B_in.shape[3]}")
    if y_dtype != x.dtype and not (variant == "tc" and y_dtype == torch.float32):
        raise ValueError(f"K2 {variant} does not write y in {y_dtype} from {x.dtype} x")
    tf32 = tf32 and variant == "tc"
    if x.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {x.device}")
    tensors = (x, dt, A, B_in, C_in) + (() if h0 is None else (h0,))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K2 wants contiguous head-major x, dt, A, B, C and h0")
    Bz, H, S, P = x.shape
    G, N = B_in.shape[1], B_in.shape[3]
    if P > MAX_HEAD_DIM or N > MAX_D_STATE:
        raise ValueError(f"K2 takes head_dim P <= {MAX_HEAD_DIM} and d_state "
                         f"N <= {MAX_D_STATE}, got P={P}, N={N}")
    if Bz > 65535:
        raise ValueError(f"K2 takes batch <= 65535, got {Bz}")
    if variant == "tc" and any(t.data_ptr() % 16 for t in (x, B_in, C_in)):
        raise ValueError("K2's tensor-core kernel wants x, B and C 16-byte aligned")
    y = torch.empty(x.shape, dtype=y_dtype, device=x.device)
    state = torch.empty((Bz, H, P, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_in.data_ptr(),
                     C_in.data_ptr(), None if h0 is None else h0.data_ptr(),
                     y.data_ptr(), state.data_ptr(), _DTYPE_CODES[x.dtype],
                     _DTYPE_CODES[y_dtype], _DTYPE_CODES[dt.dtype], _VARIANT_CODES[variant],
                     int(tf32), Bz, H, G, S, P, N, stream)
    if err != 0:
        raise RuntimeError(f"K2 SSD scan ({variant}) launch failed: CUDA error {err}")
    ssd_scan_hmajor.launches += 1
    ssd_scan_hmajor.launches_by_variant[variant] += 1
    return y, state


def occupancy(variant, P):
    """(dynamic shared memory in bytes, blocks per SM) of the kernel that
    ``variant`` launches at head dim ``P``, on the current CUDA device."""
    fn = build.load("ssd_scan").repro_ssd_scan_occupancy
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(_VARIANT_CODES[variant], int(P), ctypes.byref(smem), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"K2 occupancy query ({variant}, P {P}) failed: CUDA error {err}")
    return smem.value, blocks.value


ssd_scan_hmajor.launches = 0
ssd_scan_hmajor.launches_by_variant = {"tc": 0, "fma": 0}
