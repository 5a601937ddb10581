"""K2: the Mamba-2 SSD chunked scan, a CUDA C++ kernel for Hopper, and its
plain version.

Layout (head-major): x [B, H, S, P]; dt [B, H, S]; A [H];
B_in/C_in [B, G, S, N]; outputs y [B, H, S, P] in x's type and the final
state [B, H, P, N] in fp32.  The kernel (``csrc/ssd_scan.cu``) replaces the
Pallas TPU kernel of ``repro.kernels.ssd_scan``.  It has three variants;
``k2_variant`` chooses:

* "wg" (bf16 x, B and C at P and N of 64 or 128: every full-width path,
  mamba2 and Jamba) cuts each (b, h) sequence into segments of whole 64-row
  chunks (``k2_segments``) and runs Hopper's warpgroup MMA fed by TMA.  A
  call is one CUDA kernel with one segment and three with more: the
  segments' states from zero, a pass that carries the state across them,
  then every segment's outputs from its incoming state.
* "tc" (the other bf16 shapes: ``reduced()`` configs, P = N = 16) runs
  ``mma.sync``, one block per (b, h) walking every chunk in order; it is
  also the before-time of "wg" on the same inputs.
* "fma" (f32, and bf16 that neither takes) runs fp32 FMA on CUDA cores.

``ssd_scan_hmajor`` launches the kernel for CUDA tensors and runs the plain
version only for tensors on the CPU.  Every other tensor (on the meta
device, a fake tensor, a DTensor) goes through the custom op
``repro_torch::ssd_scan_hmajor``: its fake function gives empty outputs of
the right shapes and types and computes nothing.  (On a mesh the model
calls it on each shard's local tensors, models/ssm.py.)  Its operations
and bytes (``work``) are what ``analysis.account`` counts for a call.

Under autograd (grad enabled and an input that requires grad), a CUDA call
goes through ``SSDScanFn``: K2 computes the forward, and the backward
recomputes the plain chunked scan on the saved inputs and differentiates
it with autograd.  That is the gradient of the JAX package's train path,
which differentiates its jnp ``ssd_chunked`` (the Pallas kernel has no
backward either).  So the plain version here computes a gradient that no
kernel computes; no forward falls back to it.  A bare ``_launch`` refuses
inputs that require grad, since its outputs would carry no gradient.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.scope import named_scope
from repro_torch.kernels import build

DEFAULT_CHUNK = 256
MAX_HEAD_DIM = 128     # P
MAX_D_STATE = 128      # N

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODES = {"fma": 0, "tc": 1, "wg": 2}
WG_DIMS = (64, 128)    # the P and N that "wg" takes
WG_CHUNK = 64          # the kernels' own chunk length
WG_MIN_CHUNKS = 4      # the least length of a segment, in chunks
# blocks of the "wg" outputs kernel that fit on an SM (at N = 128), by P:
# what its shared memory allows (tests/test_torch_kernels_card.py reads the
# card's answer)
WG_BLOCKS_PER_SM = {64: 2, 128: 1}


def k2_variant(x_dtype, P, N):
    """"wg" (wgmma and TMA, split over the sequence) for bfloat16 x, B, C
    with P and N in ``WG_DIMS``; "tc" (mma.sync) for the other bfloat16 calls
    with P, N <= 128 and multiples of 8 (16-byte rows for its cp.async
    copies); "fma" (fp32 CUDA-core kernel) for everything else, f32
    included."""
    if x_dtype != torch.bfloat16:
        return "fma"
    if P in WG_DIMS and N in WG_DIMS:
        return "wg"
    return ("tc" if P <= MAX_HEAD_DIM and N <= MAX_D_STATE and P % 8 == 0 and N % 8 == 0
            else "fma")


def k2_segments(B, H, S, sm_count, blocks_per_sm=WG_BLOCKS_PER_SM[64]):
    """How many segments "wg" cuts each (b, h) sequence of S positions into:
    as many as fill the card's ``sm_count * blocks_per_sm`` block slots with
    B * H * count blocks of the outputs kernel in one wave, at least one,
    and no more than leave every segment ``WG_MIN_CHUNKS`` 64-row chunks
    (one segment below twice that).  A second wave would cost a whole
    segment's time for a few blocks, and each segment more costs the states
    kernel and the pass more work (PERF.md: the sweep on the card).
    """
    most = max(1, -(-S // WG_CHUNK) // WG_MIN_CHUNKS)
    return max(1, min(most, sm_count * blocks_per_sm // (B * H)))


def _lib():
    lib = build.load("ssd_scan")
    fn = lib.repro_ssd_scan_fwd
    if fn.argtypes is None:
        # x, dt, A, B, C, h0, y, state; x_dtype, y_dtype, dt_dtype, variant,
        # B, H, G, S, P, N; stream
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _lib_wg():
    fn = build.load("ssd_scan").repro_ssd_scan_wg_fwd
    if fn.argtypes is None:
        # x, dt, A, B, C, h0, y, state, seg_state, seg_decay; dt_dtype, B, H,
        # G, S, P, N, nseg; stream
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    (y [B,H,S,P] in x's dtype, state [B,H,P,N] fp32).  It computes in
    float32, or in float64 for float64 inputs (the gradient check of
    ``SSDScanFn``).
    """
    Bz, H, S, P = x.shape
    G, N = B_in.shape[1], B_in.shape[3]
    hg = H // G
    ct = torch.promote_types(x.dtype, torch.float32)
    pad = (-S) % chunk
    xf = F.pad(x.to(ct), (0, 0, 0, pad)).reshape(Bz, G, hg, -1, chunk, P)
    dtf = F.pad(dt.to(ct), (0, pad)).reshape(Bz, G, hg, -1, chunk)
    Bf = F.pad(B_in.to(ct), (0, 0, 0, pad)).reshape(Bz, G, -1, chunk, N)
    Cf = F.pad(C_in.to(ct), (0, 0, 0, pad)).reshape(Bz, G, -1, chunk, N)
    nc = xf.shape[3]
    Ar = A.to(ct).reshape(G, hg)[None, :, :, None]                  # [1,G,hg,1]
    h = (torch.zeros((Bz, G, hg, P, N), dtype=ct, device=x.device)
         if h0 is None else h0.to(ct).reshape(Bz, G, hg, P, N))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xf[:, :, :, c], dtf[:, :, :, c], Bf[:, :, c], Cf[:, :, c]
        cum = torch.cumsum(dtc * Ar, dim=-1)                         # [b,G,hg,Q]
        total = cum[..., -1]                                         # [b,G,hg]
        # intra-chunk: cum_i - cum_j for i < j is positive and exp() of it
        # overflows once a chunk's decay passes ~88 (mamba2-1.3b's does at
        # full width), so the exponent is masked before the exp: the kept
        # entries are as before, and no inf meets the gradient (JAX's jnp
        # ssd_chunked masks after the exp, and its gradient is NaN there)
        CB = torch.einsum("bgin,bgjn->bgij", Cc, Bc)                 # [b,G,Q,Q]
        seg = torch.where(tri, cum[..., :, None] - cum[..., None, :], -torch.inf)
        att = CB[:, :, None] * torch.exp(seg) * dtc[..., None, :]    # [b,G,hg,Q,Q]
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
    current stream (one call, counted in ``ssd_scan_hmajor.launches`` and,
    by variant, in ``.launches_by_variant``, whether it runs one CUDA kernel
    or, "wg" over several segments, three); the kernels tile the sequence
    in chunks of their own length (64 rows, so that the [Q,Q] tile fits in
    shared memory) and ignore ``chunk``: the result depends on the chunk
    length only through float rounding.  Under autograd the launch goes
    through ``SSDScanFn``, whose backward takes chunks of ``chunk`` rows.
    """
    _check(x, dt, A, B_in, C_in, h0)
    if type(x) is torch.Tensor and x.device.type == "cpu":
        return ssd_scan_hmajor_plain(x, dt, A, B_in, C_in, chunk=chunk, h0=h0)
    if _wants_grad(x, dt, A, B_in, C_in, h0):
        return SSDScanFn.apply(x, dt, A, B_in, C_in, h0, chunk)
    return torch.ops.repro_torch.ssd_scan_hmajor(x, dt, A, B_in, C_in, h0, chunk)


@torch.library.custom_op("repro_torch::ssd_scan_hmajor", mutates_args=())
def _ssd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_in: torch.Tensor,
            C_in: torch.Tensor, h0: Optional[torch.Tensor],
            chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 as an op: a CUDA tensor launches ``k2_variant``'s kernel with y in
    x's type, a CPU tensor (a DTensor's shard on a CPU mesh) runs the plain
    version."""
    if x.device.type == "cpu":
        return ssd_scan_hmajor_plain(x, dt, A, B_in, C_in, chunk=chunk, h0=h0)
    return _launch(x, dt, A, B_in, C_in, h0, k2_variant(x.dtype, x.shape[3], B_in.shape[3]),
                   x.dtype)


@_ssd_op.register_fake
def _ssd_fake(x, dt, A, B_in, C_in, h0, chunk):
    Bz, H, _, P = x.shape
    return torch.empty_like(x), x.new_empty((Bz, H, P, B_in.shape[3]), dtype=torch.float32)


def work(x_shape, G, N, x_itemsize=2, dt_itemsize=4, Q=256):
    """(flops, bytes) of one K2 call on x [B,H,S,P] with G groups of d_state
    N: bytes read and written once (x in, y out, dt, A, B and C in, the
    fp32 state out); operations of the chunk-``Q`` block decomposition (C B^T
    once per group and chunk, the causal half of att @ x, C @ state^T and
    the state update)."""
    B, H, S, P = x_shape
    nc = -(-S // Q)
    flops = (2 * Q * Q * N * B * G * nc                    # C B^T
             + 2 * (Q * (Q + 1) // 2) * P * B * H * nc     # att @ x, causal half
             + 2 * Q * N * P * B * H * nc                  # C @ state^T
             + 2 * P * N * Q * B * H * nc)                 # state update
    nbytes = (B * H * S * P * x_itemsize * 2 + B * H * S * dt_itemsize + H * 4
              + 2 * B * G * S * N * x_itemsize + B * H * P * N * 4)
    return flops, nbytes


def _wants_grad(*tensors):
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


class SSDScanFn(torch.autograd.Function):
    """K2 under autograd: the op's forward (on the card the kernel,
    ``k2_variant``'s choice, y in x's type), and a backward that reruns the plain chunked scan with chunks
    of ``chunk`` rows on detached copies of the saved inputs (in the
    "ssd_core" scope) and returns its autograd gradient (a state gradient
    that is None counts as zero)."""

    @staticmethod
    def forward(ctx, x, dt, A, B_in, C_in, h0, chunk):
        y, state = torch.ops.repro_torch.ssd_scan_hmajor(x, dt, A, B_in, C_in, h0, chunk)
        ctx.save_for_backward(x, dt, A, B_in, C_in, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, gy, gstate):
        needs = ctx.needs_input_grad[:6]
        with torch.enable_grad(), named_scope("ssd_core"):
            ins = [None if t is None else t.detach().requires_grad_(need)
                   for t, need in zip(ctx.saved_tensors, needs)]
            y, state = ssd_scan_hmajor_plain(*ins[:5], chunk=ctx.chunk, h0=ins[5])
            pairs = [(o, g) for o, g in ((y, gy), (state, gstate)) if g is not None]
            wanted = [t for t, need in zip(ins, needs) if t is not None and need]
            grads = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                             [g for _, g in pairs], allow_unused=True)
                         if pairs and wanted else [None] * len(wanted))
        return (*(next(grads) if t is not None and need else None
                  for t, need in zip(ins, needs)), None)


def _takes(variant, x_dtype, P, N):
    """Whether K2's ``variant`` takes bf16 or f32 x at head dim P, d_state N."""
    if variant == "wg":
        return k2_variant(x_dtype, P, N) == "wg"
    if variant == "tc":
        return k2_variant(x_dtype, P, N) != "fma"
    return variant == "fma"


def _launch(x, dt, A, B_in, C_in, h0, variant, y_dtype, segments=None):
    """Launch ``variant`` ("wg", "tc" or "fma") of K2 on checked CUDA
    tensors, with y in ``y_dtype``.  The serve path takes ``k2_variant``'s
    choice and y in x's type; tests/test_torch_kernels_card.py also runs
    "tc" with y in float32 (y before it is rounded to bf16) through here,
    and "wg" with its ``segments`` set (default: ``k2_segments``'s count for
    this card).  A variant, y type or segment count that cannot take the
    call raises."""
    if not _takes(variant, x.dtype, x.shape[3], B_in.shape[3]):
        raise ValueError(f"K2 variant {variant!r} does not take {x.dtype} at "
                         f"P={x.shape[3]}, N={B_in.shape[3]}")
    if y_dtype != x.dtype and not (variant == "tc" and y_dtype == torch.float32):
        raise ValueError(f"K2 {variant} does not write y in {y_dtype} from {x.dtype} x")
    n_chunks = -(-x.shape[2] // WG_CHUNK)
    if segments is not None and (variant != "wg" or not 1 <= segments <= n_chunks):
        raise ValueError(f"K2 {variant} does not take {segments} segments of "
                         f"{n_chunks} chunks")
    if _wants_grad(x, dt, A, B_in, C_in, h0):
        raise RuntimeError("K2 launched on inputs that require grad would return outputs "
                           "without a gradient: call ssd_scan_hmajor, which takes SSDScanFn")
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
    if variant != "fma" and any(t.data_ptr() % 16 for t in (x, B_in, C_in)):
        raise ValueError("K2's tensor-core kernels want x, B and C 16-byte aligned")
    y = torch.empty(x.shape, dtype=y_dtype, device=x.device)
    state = torch.empty((Bz, H, P, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    h0_ptr = None if h0 is None else h0.data_ptr()
    with torch.cuda.device(x.device):
        if variant == "wg":
            nseg = segments if segments is not None else k2_segments(
                Bz, H, S, _sm_count(x.device), WG_BLOCKS_PER_SM[P])
            # the segments' states, then (in place) their incoming states; and
            # each segment's decay sum (none with one segment)
            seg_state = seg_decay = None
            if nseg > 1:
                seg_state = torch.empty((Bz, H, nseg - 1, P, N), dtype=torch.float32,
                                        device=x.device)
                seg_decay = torch.empty((Bz, H, nseg - 1), dtype=torch.float32,
                                        device=x.device)
            err = _lib_wg()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_in.data_ptr(),
                            C_in.data_ptr(), h0_ptr, y.data_ptr(), state.data_ptr(),
                            None if seg_state is None else seg_state.data_ptr(),
                            None if seg_decay is None else seg_decay.data_ptr(),
                            _DTYPE_CODES[dt.dtype], Bz, H, G, S, P, N, nseg, stream)
        else:
            err = _lib()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_in.data_ptr(),
                         C_in.data_ptr(), h0_ptr, y.data_ptr(), state.data_ptr(),
                         _DTYPE_CODES[x.dtype], _DTYPE_CODES[y_dtype], _DTYPE_CODES[dt.dtype],
                         _VARIANT_CODES[variant], Bz, H, G, S, P, N, stream)
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
ssd_scan_hmajor.launches_by_variant = {"wg": 0, "tc": 0, "fma": 0}
