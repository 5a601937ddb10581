"""A hybrid Mamba-2 / attention stack with a mixture of experts after every
layer (Granite 4.0-H's layer, granitemoehybrid).

Each layer: pre-norm mixer (a Mamba-2 layer, or grouped-query attention
with no positional encoding at the indices ``layer_types`` names), its
output times ``residual_multiplier`` added; then a pre-norm MoE FFN (the
router over every expert, top-k, the held experts' SwiGLUs and a shared
SwiGLU), its output times ``residual_multiplier`` added.  The program
holds the layers as period groups of ``layer_types``' pattern
(``models.lm.HybridGroup``); here each kind of weight is stacked over its
own layers: norms over the groups, attention over the attention layers,
Mamba-2 over the Mamba-2 layers, the MoE over every layer.

The Mamba-2 weights are drawn as the ``ssm`` family draws them, the
attention's as the ``dense`` family's (no tied query head: at a softmax
scale of 1/128 a token's own key would not stand out anyway).  The
embedding is scaled after the draw so that ``embedding_multiplier``, in
place of sqrt(hidden), gives the first layer's input rms 0.1.
"""
from __future__ import annotations

import contextlib
import functools
from pathlib import Path

from cardbench import families
from cardbench.faults import patched
from cardbench.weights import stacked
from cardbench.yardstick import k1_work, k2_work

FIELDS = {"num_attention_heads": "num_heads", "num_key_value_heads": "num_kv_heads",
          "head_dim": "head_dim", "rms_norm_eps": "norm_eps", "attention_impl": "attention_impl",
          "embedding_multiplier": "embedding_multiplier",
          "residual_multiplier": "residual_multiplier", "logits_scaling": "logits_scaling",
          "attention_multiplier": "attention_multiplier"}
NESTED = {"ssm": {"mamba_d_state": "d_state", "mamba_d_head": "head_dim",
                  "mamba_expand": "expand", "mamba_n_groups": "n_groups",
                  "mamba_d_conv": "conv_width", "mamba_chunk_size": "chunk_size"},
          "moe": {"experts_published": "num_experts", "num_local_experts": "held",
                  "num_experts_per_tok": "top_k", "intermediate_size": "d_ff_expert",
                  "shared_intermediate_size": "d_ff_shared"}}
ATTN, MAMBA = "attention", "mamba"


def layout(cfg):
    """(period, attention's index in a period, groups) of ``layer_types``,
    which must repeat one period with one attention layer in it."""
    types = cfg["layer_types"]
    attn = [i for i, t in enumerate(types) if t == ATTN]
    per = attn[1] - attn[0] if len(attn) > 1 else len(types)
    if (set(types) - {ATTN, MAMBA} or len(types) % per
            or types != types[:per] * (len(types) // per) or types[:per].count(ATTN) != 1):
        raise ValueError(f"{cfg['name']}: layer_types is not one period with one "
                         "attention layer, repeated")
    return per, attn[0], len(types) // per


@functools.lru_cache(maxsize=None)
def _ssm():
    """The ``ssm`` family's module beside this file: its draws and its fault."""
    return families.load_file(Path(__file__).with_name("ssm.py"), "family")


def _mamba_shape(cfg):
    """(d_inner, heads, head size, groups, state size) of a Mamba-2 layer."""
    di = cfg["mamba_expand"] * cfg["hidden_size"]
    P = cfg["mamba_d_head"]
    return di, di // P, P, cfg["mamba_n_groups"], cfg["mamba_d_state"]


def _attention_shape(cfg):
    """(q heads, kv heads, head size) of an attention layer."""
    return cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]


def specs(cfg) -> dict:
    ssm = _ssm()
    D = cfg["hidden_size"]
    per, _, G = layout(cfg)
    n_attn, L = G, cfg["num_hidden_layers"]
    di, nh, _, g, N = _mamba_shape(cfg)
    GN, W = g * N, cfg["mamba_d_conv"]
    H, K, hd = _attention_shape(cfg)
    E, F, Fs = cfg["experts_published"], cfg["intermediate_size"], cfg["shared_intermediate_size"]
    held = cfg["num_local_experts"]
    s = stacked(G, {"ln_mix": ((per, D), "normal", 0.1), "ln_ffn": ((per, D), "normal", 0.1)})
    s.update(stacked(n_attn, {
        "attn_wq": ((D, H, hd), "normal", D ** -0.5),
        "attn_wk": ((D, K, hd), "normal", D ** -0.5),
        "attn_wv": ((D, K, hd), "normal", D ** -0.5),
        "attn_wo": ((H, hd, D), "normal", (H * hd) ** -0.5)}))
    s.update(stacked(L - n_attn, {
        "mamba_w_z": ((D, di), "normal", D ** -0.5), "mamba_w_x": ((D, di), "normal", D ** -0.5),
        "mamba_w_B": ((D, GN), "normal", D ** -0.5), "mamba_w_C": ((D, GN), "normal", D ** -0.5),
        "mamba_w_dt": ((D, nh), "normal", D ** -0.5),
        "mamba_dt_bias": ((nh,), ssm.dt_bias, None), "mamba_a_log": ((nh,), ssm.a_log, None),
        "mamba_d_skip": ((nh,), ssm.skip, None),
        "mamba_conv_w": ((W, di), "normal", W ** -0.5), "mamba_conv_b": ((di,), "normal", 0.1),
        "mamba_conv_wB": ((W, GN), "normal", W ** -0.5), "mamba_conv_bB": ((GN,), "normal", 0.1),
        "mamba_conv_wC": ((W, GN), "normal", W ** -0.5), "mamba_conv_bC": ((GN,), "normal", 0.1),
        "mamba_norm": ((di,), "normal", 0.1),
        "mamba_w_out": ((di, D), "normal", di ** -0.5)}))
    s.update(stacked(L, {
        "moe_router": ((D, E), "normal", D ** -0.5),
        "moe_w_gate": ((held, D, F), "normal", D ** -0.5),
        "moe_w_up": ((held, D, F), "normal", D ** -0.5),
        "moe_w_down": ((held, F, D), "normal", F ** -0.5),
        "moe_w_shared_gate": ((D, Fs), "normal", D ** -0.5),
        "moe_w_shared_up": ((D, Fs), "normal", D ** -0.5),
        "moe_w_shared_down": ((Fs, D), "normal", Fs ** -0.5)}))
    return s


def after_draw(cfg, w):
    """The embedding times embedding_multiplier, as the model takes it, at
    the rms that sqrt(hidden) gives the draw (``weights.py``)."""
    w["embed"].mul_(cfg["hidden_size"] ** 0.5 / cfg["embedding_multiplier"])


def param_name(cfg, key, i):
    kind, _, name = key.partition("_")
    if kind == "ln":
        return f"groups.{i}.{key}"
    if kind == "attn":
        return f"groups.{i}.attn.{name}"
    per = layout(cfg)[0]
    if kind == "mamba":
        return f"groups.{i // (per - 1)}.mamba.{i % (per - 1)}.{name}"
    return f"groups.{i // per}.moe.{i % per}.{name}"


def projection_params(cfg) -> int:
    """Per token, every layer: the mixers' projections, the router, the
    shared expert and top_k x held / published of the routed experts (the
    pairs computed here on average)."""
    D, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    n_attn = layout(cfg)[2]
    di, nh, _, g, N = _mamba_shape(cfg)
    H, K, hd = _attention_shape(cfg)
    E, k, held = cfg["experts_published"], cfg["num_experts_per_tok"], cfg["num_local_experts"]
    mamba = D * (2 * di + 2 * g * N + nh) + di * D
    attn = 2 * D * H * hd + 2 * D * K * hd
    moe = (D * E + 3 * D * cfg["shared_intermediate_size"]
           + k * held * 3 * D * cfg["intermediate_size"] // E)
    return (L - n_attn) * mamba + n_attn * attn + L * moe


def mixer_flops(cfg, seq) -> int:
    """The SSD's chunked products in the Mamba-2 layers, causal attention's
    score and value products in the attention layers."""
    n_attn, L = layout(cfg)[2], cfg["num_hidden_layers"]
    _, nh, P, g, N = _mamba_shape(cfg)
    H, K, hd = _attention_shape(cfg)
    return ((L - n_attn) * k2_work(1, nh, seq, P, g, N, Q=cfg["mamba_chunk_size"])[0]
            + n_attn * k1_work(1, H, K, seq, seq, hd)[0])


@contextlib.contextmanager
def state_unchanged():
    """The Mamba-2 steps return the states they were given, and the KV cache
    never gets the new key and value."""
    from repro_torch.models import lm
    with _ssm().state_unchanged(), patched(lm, "_write_pos", lambda buf, pos, val: None):
        yield
