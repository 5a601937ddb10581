"""Plain float32 reference of a hybrid Mamba-2 / attention stack with a
mixture of experts after every layer (Granite 4.0-H's layer).

One sequence at a time, the whole sequence through every layer, no cache.
For each layer, with ``m`` the residual multiplier:

    h  = x + m * mixer(norm(x))
    x' = h + m * (sum over the top-k experts held here of g_e SwiGLU_e(norm(h))
                  + SwiGLU_shared(norm(h)))

The mixer is the Mamba-2 layer of ``reference/ssm.py`` (its convolution and
its SSD) where ``layer_types`` says "mamba", and grouped-query causal
attention with no positional encoding and softmax scale
``attention_multiplier`` where it says "attention".  The router scores
every expert (``experts_published``); a token's gates are the softmax of
its ``num_experts_per_tok`` largest router logits; only experts
0 .. ``num_local_experts`` - 1 are computed, as on the chip that holds them
(``assumed`` in the configuration).  The embedding is multiplied by
``embedding_multiplier``, the head is tied to it and the logits are divided
by ``logits_scaling``.  A norm's weight is stored as an offset from 1, as
in the program under test.  Each layer's weights are cast to float32 as
they are used, so that the reference fits beside the served model.
Imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cardbench.reference.common import f32, full_precision, matmul, rms_norm
from cardbench.reference.dense import _causal_attention
from cardbench.reference.ssm import _causal_conv, ssd


def _mamba(u, w, i, cfg, fp8):
    """Mamba-2 layer ``i`` (of the Mamba-2 layers) on u [S, D] (normed)."""
    S, D = u.shape
    di, P = cfg["mamba_expand"] * D, cfg["mamba_d_head"]
    nh, G, N = di // P, cfg["mamba_n_groups"], cfg["mamba_d_state"]
    lw = {k[len("layers.mamba_"):]: t[i] for k, t in w.items() if k.startswith("layers.mamba_")}
    z = matmul(u, lw["w_z"], fp8)
    xc = F.silu(_causal_conv(matmul(u, lw["w_x"], fp8), lw["conv_w"], lw["conv_b"]))
    Bp = F.silu(_causal_conv(matmul(u, lw["w_B"], fp8), lw["conv_wB"], lw["conv_bB"]))
    Cp = F.silu(_causal_conv(matmul(u, lw["w_C"], fp8), lw["conv_wC"], lw["conv_bC"]))
    dt = F.softplus(matmul(u, lw["w_dt"], fp8) + f32(lw["dt_bias"]))
    A = -torch.exp(f32(lw["a_log"]))
    xh = xc.view(S, nh, P)
    y = ssd(xh, dt, A, Bp.view(S, G, N), Cp.view(S, G, N))
    y = (y + f32(lw["d_skip"])[:, None] * xh).reshape(S, di) * F.silu(z)
    return matmul(rms_norm(y, lw["norm"], cfg["rms_norm_eps"]), lw["w_out"], fp8)


def _attention(u, w, i, cfg, fp8):
    """Attention layer ``i`` (of the attention layers) on u [S, D]: no
    positions, softmax scale ``attention_multiplier``."""
    S, D = u.shape
    H, K, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    q = matmul(u, w["layers.attn_wq"][i].reshape(D, H * hd), fp8).view(S, H, hd)
    k = matmul(u, w["layers.attn_wk"][i].reshape(D, K * hd), fp8).view(S, K, hd)
    v = matmul(u, w["layers.attn_wv"][i].reshape(D, K * hd), fp8).view(S, K, hd)
    # dense's attention divides the scores by sqrt(hd): q carries the rest
    q = q * (cfg["attention_multiplier"] * hd ** 0.5)
    o = _causal_attention(q, k, v)
    return matmul(o.reshape(S, H * hd), w["layers.attn_wo"][i].reshape(H * hd, D), fp8)


def _swiglu(u, wg, wu, wd, fp8):
    return matmul(F.silu(matmul(u, wg, fp8)) * matmul(u, wu, fp8), wd, fp8)


def _moe(u, w, i, cfg, fp8):
    """The MoE FFN of layer ``i`` on u [S, D] (normed): the held experts'
    share of the routed output, plus the shared expert."""
    k, held = cfg["num_experts_per_tok"], cfg["num_local_experts"]
    lw = {k_[len("layers.moe_"):]: t[i] for k_, t in w.items() if k_.startswith("layers.moe_")}
    top, experts = torch.topk(matmul(u, lw["router"], fp8), k, dim=-1)
    gates = torch.softmax(top, dim=-1)                        # [S, k]
    out = _swiglu(u, lw["w_shared_gate"], lw["w_shared_up"], lw["w_shared_down"], fp8)
    for e in range(held):
        tok, slot = torch.nonzero(experts == e, as_tuple=True)
        if tok.numel():
            y = _swiglu(u[tok], lw["w_gate"][e], lw["w_up"][e], lw["w_down"][e], fp8)
            out[tok] += gates[tok, slot][:, None] * y
    return out


def layer_kinds(cfg):
    """For each layer: ("attention" or "mamba", its index among its kind,
    its group, its index in the group)."""
    types = cfg["layer_types"]
    per = len(types) // (types.count("attention") or 1)
    seen, out = {"attention": 0, "mamba": 0}, []
    for i, t in enumerate(types):
        if t not in seen:
            raise ValueError(f"unknown layer type {t!r}")
        out.append((t, seen[t], i // per, i % per))
        seen[t] += 1
    return out


@torch.no_grad()
def logits(w, cfg, tokens, positions, fp8=False):
    """The logits [len(positions), vocab] at ``positions`` of the sequence
    ``tokens`` [S] (ids, on the weights' device).  ``w`` holds the weights
    (``cardbench.weights``); ``fp8`` rounds every product's operands to
    float8 (the control)."""
    full_precision()
    if cfg["position_embedding_type"] != "nope":
        raise ValueError("this reference has no positional encoding")
    eps, V, m = cfg["rms_norm_eps"], cfg["vocab_size"], cfg["residual_multiplier"]
    x = f32(w["embed"][tokens]) * cfg["embedding_multiplier"]
    for i, (kind, j, g, r) in enumerate(layer_kinds(cfg)):
        u = rms_norm(x, w["layers.ln_mix"][g, r], eps)
        mixer = _attention if kind == "attention" else _mamba
        x = x + m * mixer(u, w, j, cfg, fp8)
        x = x + m * _moe(rms_norm(x, w["layers.ln_ffn"][g, r], eps), w, i, cfg, fp8)
        del u
    x = rms_norm(x[positions], w["final_norm"], eps)
    return matmul(x, w["embed"].T[:, :V], fp8) / cfg["logits_scaling"]
