"""Mixture-of-Experts FFN: top-k routing with capacity, the counterpart of
``repro.models.moe``.

``dense``   one-hot dispatch einsum (GShard-style): O(T*E*C) memory, the
            small-shape oracle of the tests.
``index``   the single-device form of the JAX package's expert-parallel
            path: routing and capacity ranking, token ids scattered into
            [E, C] slot buffers (sentinel id T for an empty slot), a
            gather from the tokens padded with one zero row, each expert's
            SwiGLU as batched products, and a scatter-add into a [T+1, D]
            buffer whose sentinel row is dropped.  Peak memory is
            O(E * C * D).
``sharded`` the expert-parallel path over the plan's mesh
            (``moe_ffn_sharded``): one local function per shard, as JAX's
            ``shard_map`` runs it, on DTensors' local shards, with the
            collectives of the JAX package issued as functional
            collectives over the mesh's axes.

All are plain PyTorch: the JAX package computes the dispatch in jnp, with
no Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.scope import named_scope
from repro_torch.sharding.plan import per_shard


def router_probs(x2d, w_router):
    """Softmax over experts of float32 router logits.  x2d [T,D]; w [D,E].
    (JAX's optional router jitter is passed by no caller and not ported.)"""
    return torch.softmax(x2d.float() @ w_router.float(), dim=-1)


def _topk_gates(probs, top_k, norm_topk=True):
    gates, eidx = torch.topk(probs, top_k, dim=-1)                # [T,k], descending
    if norm_topk:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, eidx


def load_balance_loss(probs, eidx, num_experts):
    """Switch-transformer aux loss: E * sum_e f_e * p_e."""
    T = probs.shape[0]
    flat = eidx.reshape(-1)
    counts = torch.zeros((num_experts,), dtype=torch.float32, device=probs.device)
    counts.scatter_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                            device=probs.device))
    f = counts / max(T * eidx.shape[-1], 1)
    p = probs.mean(dim=0)
    return num_experts * torch.sum(f * p)


def _capacity(T, moe: MoEConfig) -> int:
    return max(1, int(T * moe.top_k * moe.capacity_factor / moe.num_experts))


def _rank_within_expert(eidx_flat, num_experts):
    """Position of each (token, k) pair within its expert's arrival order."""
    P = eidx_flat.shape[0]
    order = torch.argsort(eidx_flat, stable=True)
    sorted_e = eidx_flat[order]
    experts = torch.arange(num_experts, device=eidx_flat.device, dtype=sorted_e.dtype)
    seg_start = torch.searchsorted(sorted_e, experts, side="left")
    rank_sorted = torch.arange(P, device=eidx_flat.device) - seg_start[sorted_e]
    pos = torch.empty_like(rank_sorted)
    pos[order] = rank_sorted
    return pos


def _one_hot(idx, n, dtype):
    """one_hot(idx, n) with an index of n giving a row of zeros, as
    ``jax.nn.one_hot`` gives for an index out of range."""
    return F.one_hot(idx, n + 1)[..., :n].to(dtype)


def moe_ffn_dense(x, params, moe: MoEConfig):
    """Oracle.  x [B,S,D] -> ([B,S,D], aux_loss)."""
    B, S, D = x.shape
    T, E, k = B * S, moe.num_experts, moe.top_k
    xt = x.reshape(T, D)
    probs = router_probs(xt, params["router"])
    gates, eidx = _topk_gates(probs, k)
    aux = load_balance_loss(probs, eidx, E)
    C = _capacity(T, moe)

    pos = _rank_within_expert(eidx.reshape(-1), E).reshape(T, k)
    slot = torch.where(pos < C, pos, C)
    # dispatch and combine tensors [T,k] -> [T,E,C]
    disp = (_one_hot(eidx, E, xt.dtype)[..., None]
            * _one_hot(slot, C, xt.dtype)[..., None, :]).sum(dim=1)
    buf = torch.einsum("tec,td->ecd", disp, xt)
    h = _expert_swiglu(buf, params)
    gate_disp = (_one_hot(eidx, E, torch.float32)[..., None]
                 * _one_hot(slot, C, torch.float32)[..., None, :]
                 * gates[..., None, None]).sum(dim=1)
    y = torch.einsum("tec,ecd->td", gate_disp.to(h.dtype), h)
    return y.reshape(B, S, D), aux


def _expert_swiglu(buf, params):
    """buf [E,C,D] -> [E,C,D] through each expert's SwiGLU (in the
    "experts" scope: see ``models.lm._save_unbatched_products``)."""
    with named_scope("experts"):
        hg = torch.bmm(buf, params["w_gate"])
        hu = torch.bmm(buf, params["w_up"])
        h = F.silu(hg.float()).to(buf.dtype) * hu
        return torch.bmm(h, params["w_down"])


def moe_ffn_index(x, params, moe: MoEConfig):
    """The index-buffer path.  x [B,S,D] -> ([B,S,D], aux_loss)."""
    B, S, D = x.shape
    T, E, k = B * S, moe.num_experts, moe.top_k
    xt = x.reshape(T, D)
    probs = router_probs(xt, params["router"])
    gates, eidx = _topk_gates(probs, k)
    aux = load_balance_loss(probs, eidx, E)
    C = _capacity(T, moe)

    e_flat = eidx.reshape(-1)
    pos = _rank_within_expert(e_flat, E)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    kept = pos < C
    e_slot = torch.where(kept, e_flat, E)                  # row E: the drop row
    c_slot = torch.clamp(pos, max=C - 1)
    # index / gate buffers [E, C]; sentinel token id T
    tok_buf = torch.full((E + 1, C), T, dtype=torch.long, device=x.device)
    tok_buf[e_slot, c_slot] = torch.where(kept, tok, T)
    gate_buf = torch.zeros((E + 1, C), dtype=torch.float32, device=x.device)
    gate_buf[e_slot, c_slot] = torch.where(kept, gates.reshape(-1), 0.0)
    tok_buf, gate_buf = tok_buf[:E], gate_buf[:E]

    xt_pad = torch.cat([xt, xt.new_zeros((1, D))], dim=0)
    out_buf = _expert_swiglu(xt_pad[tok_buf], params)      # [E,C,D]
    contrib = (out_buf.float() * gate_buf[..., None]).to(x.dtype)
    y = x.new_zeros((T + 1, D))
    y.index_add_(0, tok_buf.reshape(-1), contrib.reshape(-1, D))
    return y[:T].reshape(B, S, D), aux


def _axis_index(mesh, axes) -> int:
    """This process's index along the mesh axes ``axes`` (major to minor)."""
    idx = 0
    for a in axes:
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) + mesh.get_local_rank(a)
    return idx


def _group(mesh, axis):
    return (mesh, mesh.mesh_dim_names.index(axis))


def _all_gather(t, mesh, axes, dim):
    """Tiled all-gather over ``axes`` (major to minor) along ``dim``."""
    from torch.distributed import _functional_collectives as funcol
    for a in reversed(axes):
        t = funcol.all_gather_tensor(t, dim, _group(mesh, a))
    return t


def _psum(t, mesh, axes):
    from torch.distributed import _functional_collectives as funcol
    for a in axes:
        t = funcol.all_reduce(t, "sum", _group(mesh, a))
    return t


def moe_ffn_sharded(x, params, moe: MoEConfig, plan, gather_mode="auto"):
    """Expert-parallel path. x: [B,S,D] (a DTensor, or a whole tensor that
    every rank holds alike); params' leaves likewise.  Returns (y, aux):
    DTensors for DTensor input, whole tensors for whole input.

    Each shard routes its own tokens over every expert (router replicated),
    keeps the slots of its E/|model| experts and sums the outputs over the
    model axis.  Under plan.fsdp the expert weights arrive sharded over the
    data axes on their embed dim.  Gather modes, as in the JAX package:
      "weights": all-gather the weights per layer (ZeRO-3);
      "partial": keep the weight shards, all-gather every data shard's slot
                 buffers, contract the local D-slice, all-reduce the partial
                 hg/hu, all-gather the output's D slices and take this
                 shard's slots back;
      "auto":    "weights".
    In both: y all-reduced over the model axis and aux averaged over it."""
    from torch.distributed.tensor import DTensor, Replicate
    info = plan.info
    mesh = info.mesh
    model_ax = info.model_axis
    d_axes = plan.spec("batch")[0]
    # tiny decode batches can't shard over the data axes: replicate the
    # tokens, keep expert parallelism over model
    if d_axes is not None and x.shape[0] % info.data_size != 0:
        d_axes = None
    fsdp = plan.fsdp and bool(info.data_axes)
    gather_axes = info.data_axes
    mode = "weights" if gather_mode == "auto" else gather_mode
    if mode not in ("weights", "partial"):
        raise ValueError(f"unknown gather mode {gather_mode!r}")

    def local(x_loc, w_router, w_gate, w_up, w_down):
        if fsdp and mode == "weights":
            w_gate = _all_gather(w_gate, mesh, gather_axes, 1)
            w_up = _all_gather(w_up, mesh, gather_axes, 1)
            w_down = _all_gather(w_down, mesh, gather_axes, 2)
        B, S, D = x_loc.shape
        T = B * S
        E, k = moe.num_experts, moe.top_k
        E_loc = w_gate.shape[0]
        xt = x_loc.reshape(T, D)
        probs = router_probs(xt, w_router)
        gates, eidx = _topk_gates(probs, k)
        aux = load_balance_loss(probs, eidx, E)
        C = _capacity(T, moe)

        e_flat = eidx.reshape(-1)
        pos = _rank_within_expert(e_flat, E)
        tok = torch.arange(T, device=xt.device).repeat_interleave(k)
        e_lo = (mesh.get_local_rank(model_ax) if model_ax else 0) * E_loc
        mine = (e_flat >= e_lo) & (e_flat < e_lo + E_loc) & (pos < C)
        e_local = torch.where(mine, e_flat - e_lo, E_loc)          # E_loc: the drop row
        c_slot = torch.clamp(pos, max=C - 1)
        # index / gate buffers [E_loc, C]; sentinel token id T
        tok_buf = torch.full((E_loc + 1, C), T, dtype=torch.long, device=xt.device)
        tok_buf[e_local, c_slot] = torch.where(mine, tok, T)
        gate_buf = torch.zeros((E_loc + 1, C), dtype=torch.float32, device=xt.device)
        gate_buf[e_local, c_slot] = torch.where(mine, gates.reshape(-1), 0.0)
        tok_buf, gate_buf = tok_buf[:E_loc], gate_buf[:E_loc]

        xt_pad = torch.cat([xt, xt.new_zeros((1, D))], dim=0)
        buf = xt_pad[tok_buf]                                      # [E_loc, C, D]
        if fsdp and mode == "partial":
            dz = info.data_size
            d_idx = _axis_index(mesh, gather_axes)
            d_blk = D // dz
            tokens_sharded = d_axes is not None
            buf_all = _all_gather(buf, mesh, gather_axes, 1) if tokens_sharded else buf
            buf_sl = buf_all[:, :, d_idx * d_blk:(d_idx + 1) * d_blk]
            with named_scope("experts"):
                hg = torch.bmm(buf_sl.float(), w_gate.float())
                hu = torch.bmm(buf_sl.float(), w_up.float())
                hg, hu = _psum(hg, mesh, gather_axes), _psum(hu, mesh, gather_axes)
                h = (F.silu(hg) * hu).to(buf.dtype)
                out_all = _all_gather(torch.bmm(h, w_down), mesh, gather_axes, 2)   # [E,*,D]
            out_buf = out_all[:, d_idx * C:(d_idx + 1) * C] if tokens_sharded else out_all
        else:
            out_buf = _expert_swiglu(buf, {"w_gate": w_gate, "w_up": w_up, "w_down": w_down})
        contrib = (out_buf.float() * gate_buf[..., None]).to(x_loc.dtype)
        y = x_loc.new_zeros((T + 1, D))
        y.index_add_(0, tok_buf.reshape(-1), contrib.reshape(-1, D))
        y = y[:T]
        if model_ax:
            y = _psum(y, mesh, (model_ax,))
            aux = _psum(aux, mesh, (model_ax,)) / info.model_size
        return y.reshape(B, S, D), aux

    x_pl = plan.placements_of((d_axes, None, None))
    w_in = plan.placements("experts", "embed", "expert_mlp")
    w_out = plan.placements("experts", "expert_mlp", "embed")
    rep = (Replicate(),) * mesh.ndim
    y, aux = per_shard(local, (x_pl, rep, w_in, w_in, w_out), (x_pl, rep), mesh=mesh)(
        x, params["router"], params["w_gate"], params["w_up"], params["w_down"])
    if not isinstance(x, DTensor):
        return y.full_tensor(), aux.full_tensor()
    return y, aux


def moe_ffn(x, params, moe: MoEConfig, plan=None, impl="auto", gather_mode="auto"):
    """impl "auto" or "sharded": the expert-parallel path when the plan's
    mesh is distributed, else the index path (one device); "dense": the
    oracle."""
    if impl == "dense":
        return moe_ffn_dense(x, params, moe)
    if impl in ("auto", "sharded"):
        if plan is not None and plan.info.distributed:
            return moe_ffn_sharded(x, params, moe, plan, gather_mode=gather_mode)
        return moe_ffn_index(x, params, moe)
    raise ValueError(f"unknown moe impl {impl!r}")
