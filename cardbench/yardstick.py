"""The benchmark's own yardstick: the card's peaks, the work of a model step
and of the two kernels, a roofline bound and a percentile.

Frozen here so that a change to the program cannot move it.  The K1 and K2
counts are copies of the counts the port's ``chip_smoke.py`` used when the
benchmark was written (``_k1_work``, ``_k2_work``, ``_bound`` and the work
functions they call), and the peaks are NVIDIA's data-sheet numbers.  Model
FLOPs count every matrix product of a step, the sequence mixer's included
(each family's module gives its projections and its mixer's products,
``families/__init__.py``), from the configuration file and the request's
lengths alone.
"""
from __future__ import annotations

import math

from cardbench import families

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
def prefill_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one prefill of ``batch`` prompts of ``seq`` tokens:
    2 x the projections' weights a token, the head at the last position
    only, plus the sequence mixer's products (attention's causal score and
    value products, the SSD's chunked products), every layer."""
    fam = families.module(cfg)
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    per_seq = 2 * fam.projection_params(cfg) * seq + 2 * D * V + fam.mixer_flops(cfg, seq)
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
