"""Plain float32 reference of an attention-free Mamba-2 stack.

One sequence at a time, the whole sequence through every layer, no cache.
Each layer follows Mamba-2 (arXiv:2405.21060): pre-norm RMSNorm; the input
projections z, x, B, C and dt; a depthwise causal convolution of x, B and C
(one filter a channel, the same as the published joint conv over xBC); SiLU;
dt = softplus(dt + dt_bias); A = -exp(a_log); the SSD

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,    y_t = h_t C_t + D x_t,

then y * silu(z), an RMSNorm over the inner width and the out projection,
with a residual; the head is tied to the embedding.  As in the program under
test, the embedding is multiplied by sqrt(hidden size) and a norm's weight
is stored as an offset from 1.  The SSD is evaluated exactly, chunk by
chunk (the quadratic form inside a chunk, the state carried between
chunks), with every exponent a difference of cumulative sums that is <= 0.
Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cardbench.reference.common import f32, full_precision, matmul, rms_norm

CHUNK = 256
CHUNKS_AT_ONCE = 16


def _causal_conv(x, w, b):
    """x [S, C], w [W, C], b [C]: out[t] = sum_i w[i] x[t - W + 1 + i] + b."""
    W, S = w.shape[0], x.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    w = f32(w)
    out = f32(b).expand(S, -1).clone()
    for i in range(W):
        out += xp[i:i + S] * w[i]
    return out


def ssd(x, dt, A, B, C):
    """x [S,H,P], dt [S,H], A [H] (< 0), B, C [S,G,N] -> y [S,H,P] (no skip)."""
    S, H, P = x.shape
    G, N = B.shape[1:]
    head_group = torch.arange(H, device=x.device) // (H // G)
    pad = (-S) % CHUNK
    if pad:   # dt = 0 past the end: no decay and no input there
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 1) + (0, pad)) for t in (x, dt, B, C))
    nc = x.shape[0] // CHUNK
    xs = x.view(nc, CHUNK, H, P)
    dts = dt.view(nc, CHUNK, H)
    cum = torch.cumsum(dts * A, dim=1)                       # [nc, Q, H], <= 0
    Bs, Cs = B.view(nc, CHUNK, G, N), C.view(nc, CHUNK, G, N)
    causal = torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=x.device).tril()
    y = torch.empty(nc, CHUNK, H, P, device=x.device)
    state = torch.zeros(H, P, N, device=x.device)
    for c0 in range(0, nc, CHUNKS_AT_ONCE):
        c1 = min(nc, c0 + CHUNKS_AT_ONCE)
        cm, xc, dc = cum[c0:c1], xs[c0:c1], dts[c0:c1]
        Bh, Ch = Bs[c0:c1][:, :, head_group], Cs[c0:c1][:, :, head_group]   # [c,Q,H,N]
        # inside a chunk: y_t += sum_{s<=t} exp(cum_t - cum_s) (C_t . B_s) dt_s x_s
        seg = (cm[:, :, None, :] - cm[:, None, :, :]).masked_fill(
            ~causal[None, :, :, None], float("-inf"))       # [c, t, s, H]
        mix = torch.exp(seg) * torch.einsum("cthn,cshn->ctsh", Ch, Bh) * dc[:, None]
        y[c0:c1] = torch.einsum("ctsh,cshp->cthp", mix, xc)
        # each chunk's own state, from zero, at its end
        to_end = torch.exp(cm[:, -1:, :] - cm) * dc           # [c, Q, H]
        own = torch.einsum("cqh,cqhp,cqhn->chpn", to_end, xc, Bh)
        for j in range(c1 - c0):
            # the state entering the chunk, read by every row of it
            y[c0 + j] += torch.exp(cm[j])[..., None] * torch.einsum(
                "thn,hpn->thp", Ch[j], state)
            state = torch.exp(cm[j, -1])[:, None, None] * state + own[j]
    return y.view(nc * CHUNK, H, P)[:S]


@torch.no_grad()
def logits(w, cfg, tokens, positions, fp8=False):
    """The logits [len(positions), vocab] at ``positions`` of the sequence
    ``tokens`` [S] (ids, on the weights' device).  ``w`` holds the weights
    (``cardbench.weights``); ``fp8`` rounds every product's operands to
    float8 (the control)."""
    full_precision()
    D, L, V = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    di, P = cfg["expand"] * D, cfg["head_dim"]
    nh, G, N = di // P, cfg["n_groups"], cfg["state_size"]
    eps = cfg["layer_norm_epsilon"]
    S = tokens.shape[0]
    x = f32(w["embed"][tokens]) * math.sqrt(D)
    for i in range(L):
        lw = {k[len("layers."):]: t[i] for k, t in w.items() if k.startswith("layers.")}
        u = rms_norm(x, lw["ln"], eps)
        z = matmul(u, lw["w_z"], fp8)
        xc = F.silu(_causal_conv(matmul(u, lw["w_x"], fp8), lw["conv_w"], lw["conv_b"]))
        Bp = F.silu(_causal_conv(matmul(u, lw["w_B"], fp8), lw["conv_wB"], lw["conv_bB"]))
        Cp = F.silu(_causal_conv(matmul(u, lw["w_C"], fp8), lw["conv_wC"], lw["conv_bC"]))
        dt = F.softplus(matmul(u, lw["w_dt"], fp8) + f32(lw["dt_bias"]))
        A = -torch.exp(f32(lw["a_log"]))
        xh = xc.view(S, nh, P)
        y = ssd(xh, dt, A, Bp.view(S, G, N), Cp.view(S, G, N))
        y = (y + f32(lw["d_skip"])[:, None] * xh).reshape(S, di) * F.silu(z)
        x = x + matmul(rms_norm(y, lw["norm"], eps), lw["w_out"], fp8)
        del u, z, xc, Bp, Cp, dt, xh, y
    x = rms_norm(x[positions], w["final_norm"], eps)
    head = w["embed"].T if cfg["tie_word_embeddings"] else w["lm_head"]
    return matmul(x, head[:, :V], fp8)
