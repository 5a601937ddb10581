"""Mamba-2 (SSD, state-space duality) block [arXiv:2405.21060]: the
counterpart of ``repro.models.ssm``.

Prefill and training evaluate the SSD over the whole sequence in chunks:
on the card through the hand-written K2 kernel, on the CPU through its
plain chunked block decomposition (``kernels.ssd_scan``).  Decode uses the O(1)
recurrence: h = h * exp(A dt) + dt * B (x) x ; y = C . h.  Dtypes follow
the JAX block step by step (softplus, silu, the skip term, the gate and the
norm in float32; the conv tail cached in float32).  In prefill the causal
conv and its SiLU run on the card through the hand-written K4 kernel
(``kernels.causal_conv``) when ``k4_refusal`` finds nothing against it, in
f32 and rounded once; elsewhere through the plain eager passes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.scope import named_scope
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.causal_conv import (MAX_WIDTH as K4_MAX_WIDTH, VEC as K4_VEC,
                                             causal_conv_plain)
from repro_torch.kernels.ops import copy_bytes
from repro_torch.kernels.ssd_scan import ssd_scan_hmajor
from repro_torch.models.layers import rms_norm
from repro_torch.sharding.plan import model_cut, per_shard


def ssd_chunked(x, dt, A, B, C, chunk: int, h0=None):
    """SSD over a full sequence.

    x  [b, S, H, P]   per-head inputs
    dt [b, S, H]      positive step sizes (already softplus'd)
    A  [H]            negative per-head decay
    B  [b, S, G, N]   input projections (G groups, H % G == 0)
    C  [b, S, G, N]   output projections
    h0 optional initial state [b, H, P, N]
    returns (y [b,S,H,P] in x's dtype, h_final [b,H,P,N] fp32)

    It runs inside the "ssd_core" scope, as JAX's does.  CPU tensors take
    the plain chunked scan with chunks of ``chunk`` rows; CUDA tensors take
    K2 (which tiles by its own chunk length), under autograd inside
    ``SSDScanFn``, whose backward differentiates the plain scan with chunks
    of ``chunk`` rows.  DTensors run shard by shard, as under JAX's
    shard_map (the scan is independent per batch row and head): x may be
    cut on batch (dim 0) and heads (dim 2), and the other inputs are brought
    to the matching cuts (B and C whole over the heads' mesh axis; each
    shard takes the groups of its own heads, ``_groups_of``).
    """
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        pl, cut = x.placements, _cuts(x, 2)
        groups = _groups_of(x, 2, B.shape[2])
        return per_shard(lambda x, dt, A, B, C, h0: ssd_chunked(
                             x, dt, A, groups(B), groups(C), chunk=chunk, h0=h0),
                         (pl, pl, cut(None, 0), cut(0, None), cut(0, None), cut(0, 1)),
                         (pl, cut(0, 1)))(x, dt, A, B, C, h0)
    with named_scope("ssd") as sp, named_scope("ssd_core"):
        views = [t.movedim(1, 2) for t in (x, dt, B, C)]
        if sp.recording:
            sp.note(copy_bytes=copy_bytes(*views))
        xh, dth, Bh, Ch = (t.contiguous() for t in views)
        y, h = ssd_scan_hmajor(xh, dth, A.float(), Bh, Ch, chunk=chunk,
                               h0=None if h0 is None else h0.float().contiguous())
        return y.movedim(1, 2), h


def _groups_of(t, head_dim, G):
    """A function that cuts B or C ([b, ..., G, N], its groups at dim -2,
    whole) to the groups of the heads of this rank's shard of ``t`` (a
    DTensor whose heads, at ``head_dim``, are cut over the mesh), so that
    the shard's heads keep their groups: H / G heads a group, the shard's
    heads whole groups or within one group."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    H = t.shape[head_dim]
    hg = H // G
    shape, off = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
    h0, n = off[head_dim], shape[head_dim]
    if G == 1:
        return lambda b: b
    if (n % hg if n >= hg else hg % n) or h0 % min(n, hg):
        raise NotImplementedError(f"{n} heads from head {h0} do not keep whole B/C groups "
                                  f"of {hg} heads")
    g0, g1 = h0 // hg, (h0 + n - 1) // hg + 1
    return lambda b: b[..., g0:g1, :]


def _cuts(t, head_dim_of_t):
    """``cut(batch_dim, head_dim)``: the placements of ``t``, a DTensor cut
    on batch (dim 0) and heads (dim ``head_dim_of_t``), moved to another
    tensor's batch and head dims (None: replicated there)."""
    from torch.distributed.tensor import Replicate, Shard
    pl = t.placements
    if not all(p.is_replicate() or (p.is_shard() and p.dim in (0, head_dim_of_t))
               for p in pl):
        raise NotImplementedError(f"SSD on a tensor placed {pl}: want batch/head shards only")

    def cut(batch_dim, head_dim):
        dims = [None if p.is_replicate() else (batch_dim if p.dim == 0 else head_dim)
                for p in pl]
        return tuple(Replicate() if d is None else Shard(d) for d in dims)
    return cut


def ssd_decode_step(h, x, dt, A, B, C):
    """One-token SSD update.

    h [b,H,P,N] f32; x [b,H,P]; dt [b,H]; A [H]; B,C [b,G,N].
    returns (y [b,H,P] in x's dtype, h_new).  DTensors run shard by shard,
    cut as the state h (batch dim 0, heads dim 1).
    """
    from torch.distributed.tensor import DTensor
    if isinstance(h, DTensor):
        pl, cut = h.placements, _cuts(h, 1)
        groups = _groups_of(h, 1, B.shape[1])
        return per_shard(lambda h, x, dt, A, B, C: ssd_decode_step(
                             h, x, dt, A, groups(B), groups(C)),
                         (pl, cut(0, 1), cut(0, 1), cut(None, 0), cut(0, None), cut(0, None)),
                         (cut(0, 1), pl))(h, x, dt, A, B, C)
    with named_scope("ssd_step"):
        H = h.shape[1]
        hg = H // B.shape[1]
        da = torch.exp(dt.float() * A[None])                          # [b,H]
        Bh = torch.repeat_interleave(B, hg, dim=1).float()            # [b,H,N]
        Ch = torch.repeat_interleave(C, hg, dim=1).float()
        dx = (dt[..., None] * x).float()                              # [b,H,P]
        h_new = h * da[..., None, None] + dx[..., None] * Bh[:, :, None, :]
        y = torch.einsum("bhpn,bhn->bhp", h_new, Ch)
        return y.to(x.dtype), h_new


def causal_conv(x, w, b, halo=None):
    """Depthwise causal conv. x [B,S,C]; w [W,C]; b [C]; ``halo`` [B,W-1,C]
    the rows before x (zeros if None).  On a DTensor x (cut on batch and
    channels, and maybe on the sequence) it runs per shard: each channel's
    conv needs only its own rows, and a shard of the sequence the last W-1
    rows of the shards before it (``_halo``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(x, DTensor):
        pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)

        def chan(dim):
            return tuple(Shard(dim) if p.is_shard() and p.dim == 2 else Replicate() for p in pl)
        seq = tuple(i for i, p in enumerate(pl) if p.is_shard(1))

        def local(loc, w, b):
            return causal_conv(loc, w, b, _halo(loc, w.shape[0] - 1, x, seq))
        return per_shard(local, (pl, chan(1), chan(0)), pl)(x, w, b)
    return causal_conv_plain(x, w, b, halo)


def k4_refusal(parts) -> str | None:
    """Why K4 does not take a prefill's conv and SiLU over ``parts`` (the
    layer's (x, w, b) triples of x, B and C), or None when it does.  A rule
    on the inputs alone: no DTensor (a mesh keeps the per-shard plain path),
    bfloat16 x, w and b, a width of at most ``K4_MAX_WIDTH``, channels in
    multiples of ``K4_VEC``, no gradient wanted (the JAX package has no conv
    kernel whose backward a K4 backward would mirror), on a CUDA card."""
    from torch.distributed.tensor import DTensor
    tensors = [t for part in parts for t in part]
    if any(isinstance(t, DTensor) for t in tensors):
        return "a DTensor (a mesh)"
    if any(t.dtype != torch.bfloat16 for t in tensors):
        return "dtype"
    if any(w.shape[0] > K4_MAX_WIDTH for _, w, _ in parts):
        return "width"
    if any(x.shape[-1] % K4_VEC for x, _, _ in parts):
        return "channels"
    if torch.is_grad_enabled():
        return "a gradient is wanted"
    if not _on_card(*tensors):
        return "not on a CUDA card"
    return None


def _on_card(*tensors) -> bool:
    return all(t.is_cuda for t in tensors)


def _halo(loc, n, x, dims):
    """The ``n`` rows before this rank's shard ``loc`` of the sequence of
    ``x`` (cut over mesh ``dims``, major to minor): every shard's last n rows
    gathered (an all-gather of the tails), the previous shard's taken, zeros
    before the first; None when the sequence is whole."""
    if not dims:
        return None
    from torch.distributed import _functional_collectives as funcol
    mesh = x.device_mesh
    tails = loc[:, -n:]
    for i in reversed(dims):
        tails = funcol.all_gather_tensor_autograd(tails.contiguous(), 1, (mesh, i))
    rank = 0
    for i in dims:
        rank = rank * mesh.size(i) + mesh.get_local_rank(i)
    # every rank takes its rows out of the gathered tails (zeros before the
    # first), so that every rank's backward runs the gather's reduce-scatter
    tails = torch.cat([torch.zeros_like(tails[:, :n]), tails], dim=1)
    return tails[:, rank * n:(rank + 1) * n]


def causal_conv_step(conv_state, x_new, w, b):
    """conv_state [B, W-1, C] (raw inputs); x_new [B, C] ->
    (out [B,C], new_state [B, W-1, C]).  Types promote as in JAX (a float32
    state with bfloat16 inputs computes in float32)."""
    ct = torch.promote_types(conv_state.dtype, x_new.dtype)
    full = torch.cat([conv_state.to(ct), x_new[:, None].to(ct)], dim=1)   # [B,W,C]
    wt = torch.promote_types(ct, w.dtype)
    out = torch.einsum("bwc,wc->bc", full.to(wt), w.to(wt))
    return out + b, full[:, 1:]


def _whole(t):
    """``t`` replicated on every mesh dim (``t`` itself off a mesh)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def _norm(y, w, eps: float):
    """``rms_norm`` over d_inner.  On a DTensor cut on it, each shard
    normalises its channels with the sum of squares all-reduced (left to
    DTensor, the norm's backward gathers the activations)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    last = y.dim() - 1
    if not isinstance(y, DTensor) or not any(p.is_shard(last) for p in y.placements):
        return rms_norm(y, w, eps)
    pl = y.placements
    whole = tuple(Replicate() if p.is_shard(last) else p for p in pl)
    sums = per_shard(lambda loc: torch.square(loc.float()).sum(-1, keepdim=True), (pl,),
                     tuple(Partial() if p.is_shard(last) else p for p in pl))(y)
    rstd = torch.rsqrt(sums.redistribute(sums.device_mesh, whole) / y.shape[-1] + eps)
    w_pl = tuple(Shard(0) if p.is_shard(last) else Replicate() for p in pl)
    return per_shard(lambda yl, rl, wl: (yl.float() * rl * (1.0 + wl.float())).to(yl.dtype),
                     (pl, whole, w_pl), pl)(y, rstd, w)


def mamba_block(u, p, cfg: ModelConfig, h0=None, conv0=None, decode: bool = False):
    """Full Mamba-2 mixer.

    u [B,S,D] (S==1 for decode).  p: layer params (dict of tensors).
    conv state = last (W-1) *raw* (pre-conv) xBC rows, concat channels.
    Prefill ignores ``conv0`` and starts the SSD at ``h0`` (zeros if None);
    decode needs both.  Returns (out [B,S,D], (h_final, conv_state_final)).
    """
    with named_scope("mamba"):
        s = cfg.ssm
        B_, S, D = u.shape
        di = s.d_inner(cfg.d_model)
        nh = s.n_heads(cfg.d_model)
        G, N, P = s.n_groups, s.d_state, s.head_dim
        GN = G * N

        z = u @ p["w_z"]
        xc = u @ p["w_x"]                                             # [B,S,di]
        # serving on a mesh, the B/C channels are cut over the model axis
        # through their conv and silu, as XLA partitions them there; the train
        # step keeps them whole, as XLA does under the gradient (the weights
        # gathered whole: under FSDP DTensor would rather cut the products)
        cut_bc = not torch.is_grad_enabled()
        w_B, w_C = ((model_cut(w, 1) if cut_bc else _whole(w)) for w in (p["w_B"], p["w_C"]))
        Bp = u @ w_B                                                  # [B,S,G*N]
        Cp = u @ w_C
        dt = u @ p["w_dt"]                                            # [B,S,nh]
        dt = F.softplus(dt.float() + p["dt_bias"].float())

        def silu(a):
            return F.silu(a.float()).to(u.dtype)

        with named_scope("conv") as sp:
            if decode:
                xbc_raw = torch.cat([xc, Bp, Cp], dim=-1)
                x0, B0, C0 = conv0[..., :di], conv0[..., di:di + GN], conv0[..., di + GN:]
                xc, _ = causal_conv_step(x0, xc[:, 0], p["conv_w"], p["conv_b"])
                Bp, _ = causal_conv_step(B0, Bp[:, 0], p["conv_wB"], p["conv_bB"])
                Cp, _ = causal_conv_step(C0, Cp[:, 0], p["conv_wC"], p["conv_bC"])
                xc, Bp, Cp = silu(xc[:, None]), silu(Bp[:, None]), silu(Cp[:, None])
                ct = torch.promote_types(conv0.dtype, xbc_raw.dtype)
                conv_new = torch.cat([conv0.to(ct), xbc_raw.to(ct)], dim=1)[:, 1:]
            else:
                raws = (xc, Bp, Cp)
                parts = [(xc, p["conv_w"], p["conv_b"]), (Bp, p["conv_wB"], p["conv_bB"]),
                         (Cp, p["conv_wC"], p["conv_bC"])]
                why = k4_refusal(parts)
                if sp.recording and why is None:
                    sp.note(impl="k4")
                elif sp.recording:
                    sp.note(impl="plain", why=why)
                if why is None:
                    xc, Bp, Cp = kops.causal_conv_silu(parts)
                else:
                    xc, Bp, Cp = (silu(causal_conv(*part)) for part in parts)
                # the raw rows' tail, cut before the channels are joined: on a mesh
                # only the tail of the model-sharded x channels is gathered
                W1 = s.conv_width - 1
                raw = (t[:, -W1:] if S >= W1 else F.pad(t, (0, 0, W1 - S, 0)) for t in raws)
                conv_new = torch.cat(list(raw), dim=-1).float()

        if cut_bc:      # the SSD takes B and C whole over the heads' axis
            Bp, Cp = model_cut(Bp, None), model_cut(Cp, None)
        xh = xc.reshape(B_, S, nh, P)
        Bm = Bp.reshape(B_, S, G, N)
        Cm = Cp.reshape(B_, S, G, N)
        A = -torch.exp(p["a_log"].float())                            # [nh], negative

        if decode:
            y, h_new = ssd_decode_step(h0, xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
            y = y[:, None]
        else:
            y, h_new = ssd_chunked(xh, dt, A, Bm, Cm, chunk=min(s.chunk_size, S), h0=h0)

        y = y + p["d_skip"].float()[None, None, :, None] * xh
        y = y.reshape(B_, S, di)
        y = y * F.silu(z.float()).to(y.dtype)                         # gated
        y = _norm(y, p["norm"], cfg.norm_eps)
        out = y.to(u.dtype) @ p["w_out"]
        return out.to(u.dtype), (h_new, conv_new)
