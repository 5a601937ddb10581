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

Both are plain PyTorch: the JAX package computes the dispatch in jnp, with
no Pallas kernel.  Multi-device expert parallelism comes with the sharding
slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig


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
    counts = torch.bincount(eidx.reshape(-1), minlength=num_experts).float()
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
    """buf [E,C,D] -> [E,C,D] through each expert's SwiGLU."""
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


def moe_ffn(x, params, moe: MoEConfig, impl="auto"):
    """impl "auto" or "sharded": the index path (one device); "dense": the
    oracle."""
    if impl == "dense":
        return moe_ffn_dense(x, params, moe)
    if impl in ("auto", "sharded"):
        return moe_ffn_index(x, params, moe)
    raise ValueError(f"unknown moe impl {impl!r}")
