"""The benchmark's own yardstick: the card's peaks, the work of a model step
and of the two kernels, a roofline bound and a percentile.

Frozen here so that a change to the program cannot move it.  The K1 and K2
counts are copies of the counts the port's ``chip_smoke.py`` used when the
benchmark was written (``_k1_work``, ``_k2_work``, ``_bound`` and the work
functions they call), and the peaks are NVIDIA's data-sheet numbers.  Model
FLOPs count every matrix product of a step, attention's score and value
products and the SSD's chunked products included, from the configuration
file and the request's lengths alone.
"""
from __future__ import annotations

import math

# NVIDIA's data sheets, dense rates without sparsity, at the full power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "bytes_per_s": 3.35e12,
                              "source": "NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16 "
                                        "dense, 3.35 TB/s HBM3"},
}


def peaks(card_name: str) -> dict:
    """The peaks of the card named ``card_name``; an unknown card raises, so
    that no share is reckoned against the wrong peak."""
    if card_name not in PEAKS:
        raise ValueError(f"no peaks for card {card_name!r}; known: {sorted(PEAKS)}")
    return PEAKS[card_name]


def bound_s(flops: float, nbytes: float, card: dict) -> float:
    """The least seconds the card could take for the work: the larger of the
    operations at the bf16 peak and the bytes at the memory's peak."""
    return max(flops / card["bf16_flops"], nbytes / card["bytes_per_s"])


# ------------------------------------------------------------------ kernels
def k1_work(B, H, K, Sq, Skv, hd, *, causal=True, itemsize=2):
    """(flops, bytes) of one K1 call on q [B,H,Sq,hd] and k, v [B,K,Skv,hd]:
    q.k and p.v over the (q, k) pairs a causal mask keeps (all pairs if not
    causal), 2 flops a multiply-add; q, k and v read and the output written
    once."""
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
    nbytes = itemsize * (2 * B * H * Sq * hd + 2 * B * K * Skv * hd)
    return 4 * hd * pairs * B * H, nbytes


def k2_work(B, H, S, P, G, N, *, x_itemsize=2, dt_itemsize=4, Q=256):
    """(flops, bytes) of one K2 call on x [B,H,S,P] with G groups of state
    size N: the operations of the chunk-``Q`` block decomposition (C B^T once
    a group and chunk, the causal half of att @ x, C @ state^T and the state
    update); x, dt, A, B and C read and y and the fp32 state written once."""
    nc = -(-S // Q)
    flops = (2 * Q * Q * N * B * G * nc
             + 2 * (Q * (Q + 1) // 2) * P * B * H * nc
             + 2 * Q * N * P * B * H * nc
             + 2 * P * N * Q * B * H * nc)
    nbytes = (B * H * S * P * x_itemsize * 2 + B * H * S * dt_itemsize + H * 4
              + 2 * B * G * S * N * x_itemsize + B * H * P * N * 4)
    return flops, nbytes


# ------------------------------------------------------------- model steps
def _attention_shape(cfg):
    """(q heads, kv heads, head size) of an attention layer of ``cfg``."""
    H = cfg["num_attention_heads"]
    return H, cfg["num_key_value_heads"], cfg.get("head_dim", cfg["hidden_size"] // H)


def _ssm_shape(cfg):
    """(d_inner, heads, head size, groups, state size) of a Mamba-2 layer."""
    di = cfg["expand"] * cfg["hidden_size"]
    P = cfg["head_dim"]
    return di, di // P, P, cfg["n_groups"], cfg["state_size"]


def matmul_params_per_layer(cfg) -> int:
    """Weights of one layer that multiply every token (the projections)."""
    D = cfg["hidden_size"]
    if cfg["family"] == "dense":
        H, K, hd = _attention_shape(cfg)
        return D * H * hd * 2 + D * K * hd * 2 + 3 * D * cfg["intermediate_size"]
    if cfg["family"] == "ssm":
        di, nh, _, G, N = _ssm_shape(cfg)
        return D * (2 * di + 2 * G * N + nh) + di * D
    raise ValueError(f"no FLOP count for family {cfg['family']!r}")


def prefill_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one prefill of ``batch`` prompts of ``seq`` tokens:
    2 x the projections' weights a token, the head at the last position
    only, plus attention's causal score and value products (dense) or the
    SSD's chunked products (ssm), every layer."""
    D, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    per_seq = 2 * matmul_params_per_layer(cfg) * L * seq + 2 * D * V
    if cfg["family"] == "dense":
        H, K, hd = _attention_shape(cfg)
        per_seq += L * k1_work(1, H, K, seq, seq, hd)[0]
    else:
        _, nh, P, G, N = _ssm_shape(cfg)
        per_seq += L * k2_work(1, nh, seq, P, G, N, Q=cfg["chunk_size"])[0]
    return float(batch * per_seq)


# ---------------------------------------------------------------- numbers
def percentile(values, q: float) -> float:
    """The ``q``-th percentile of ``values`` by linear interpolation between
    closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
