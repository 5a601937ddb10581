"""Plain float32 reference of a dense GQA decoder (InternLM2's layer).

One sequence at a time, the whole sequence through every layer, no cache:
the logits at any position come from the full causal forward pass.  It
follows InternLM2 (arXiv:2403.17297): pre-norm RMSNorm, rotary positions on
the two halves of each head, grouped-query causal attention with scale
1/sqrt(head size), a SwiGLU feed-forward, a final norm and an untied head.
It departs from the published model where the program under test does,
so that both compute one function: the embedding is multiplied by
sqrt(hidden size), and a norm's weight is stored as an offset from 1.
Attention runs in blocks of query rows so that it fits at 32k positions.
Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

from cardbench.reference.common import f32, full_precision, matmul, rms_norm

QUERY_BLOCK = 1024


def _rope_tables(S, hd, theta, device):
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=device) / hd)
    ang = torch.arange(S, dtype=torch.float64, device=device)[:, None] * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def _rope(x, cos, sin):
    """x [S, heads, hd]: the first half and the second half rotate together."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[:, None], sin[:, None]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def _causal_attention(q, k, v):
    """q [S,H,hd], k, v [S,K,hd] -> [S,H,hd]; q head h reads kv head h // (H/K)."""
    S, H, hd = q.shape
    K = k.shape[1]
    G = H // K
    out = torch.empty_like(q)
    for q0 in range(0, S, QUERY_BLOCK):
        q1 = min(S, q0 + QUERY_BLOCK)
        qb = q[q0:q1].reshape(q1 - q0, K, G, hd)
        scores = torch.einsum("qkgd,skd->kgqs", qb, k[:q1]) / math.sqrt(hd)
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        cols = torch.arange(q1, device=q.device)[None, :]
        scores = scores.masked_fill(cols > rows, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out[q0:q1] = torch.einsum("kgqs,skd->qkgd", probs, v[:q1]).reshape(q1 - q0, H, hd)
    return out


@torch.no_grad()
def logits(w, cfg, tokens, positions, fp8=False):
    """The logits [len(positions), vocab] at ``positions`` of the sequence
    ``tokens`` [S] (ids, on the weights' device).  ``w`` holds the weights
    (``cardbench.weights``); ``fp8`` rounds every product's operands to
    float8 (the control)."""
    full_precision()
    D, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, K, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    eps, V = cfg["rms_norm_eps"], cfg["vocab_size"]
    S = tokens.shape[0]
    cos, sin = _rope_tables(S, hd, cfg["rope_theta"], tokens.device)
    x = f32(w["embed"][tokens]) * math.sqrt(D)
    for i in range(L):
        h = rms_norm(x, w["layers.ln1"][i], eps)
        q = matmul(h, w["layers.wq"][i].reshape(D, H * hd), fp8).view(S, H, hd)
        k = matmul(h, w["layers.wk"][i].reshape(D, K * hd), fp8).view(S, K, hd)
        v = matmul(h, w["layers.wv"][i].reshape(D, K * hd), fp8).view(S, K, hd)
        o = _causal_attention(_rope(q, cos, sin), _rope(k, cos, sin), v)
        x = x + matmul(o.reshape(S, H * hd), w["layers.wo"][i].reshape(H * hd, D), fp8)
        h = rms_norm(x, w["layers.ln2"][i], eps)
        g = matmul(h, w["layers.w_gate"][i], fp8)
        u = matmul(h, w["layers.w_up"][i], fp8)
        x = x + matmul(torch.nn.functional.silu(g) * u, w["layers.w_down"][i], fp8)
        del h, q, k, v, o, g, u
    x = rms_norm(x[positions], w["final_norm"], eps)
    head = w["embed"].T if cfg["tie_word_embeddings"] else w["lm_head"]
    return matmul(x, head[:, :V], fp8)
