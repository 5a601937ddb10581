"""Weights drawn from the seed on the device, in the type they are served in.

Each kind of weight is one tensor stacked over the layers and drawn by one
call of the card's generator, so a model takes a few dozen calls.  The same
tensors go to the program (``load_into``: its parameters become views of
them) and to the plain reference, which casts them to float32 itself.

Scales: each product's weight is normal with standard deviation
1/sqrt(its contraction length); norm weights and biases 0.1 x normal (the
model adds 1 to a norm weight), so every path of a layer moves the output.
The embedding is 0.1/sqrt(hidden): the model multiplies it by sqrt(hidden),
so the first layer's input has rms 0.1 and the layers, not the input
token, decide the next token (through a tied head a larger embedding makes
the model echo its input, and the served tokens then test no state).
Mamba-2's A = -exp(a_log) is uniform in [-16, -1] and softplus(dt_bias) is
log-uniform in [1e-3, 1e-1], the published initialisation (arXiv:2405.21060).

In the dense model the first query head of each group shares its key
head's projection (wq[:, group g, 0] = wk[:, g]).  A token's own key then
scores |q|^2 / sqrt(head size), about 11 at head size 128, against about 1
for any other key, and takes most of that head's attention even at 32k
positions (a trained model attends much to itself and its neighbours too).
With independent projections the attention is near uniform, and a decode
step that never writes its own key into the cache would move the output
by a thirty-thousandth: the served tokens could not show it.
"""
from __future__ import annotations

import math

import torch

DTYPE = torch.bfloat16


def padded_vocab(cfg) -> int:
    return -(-cfg["vocab_size"] // 128) * 128


def specs(cfg) -> dict:
    """name -> (shape, init, scale).  Names without a leading "layers." are
    whole-model tensors; the others are stacked over the layers."""
    D, L, Vp = cfg["hidden_size"], cfg["num_hidden_layers"], padded_vocab(cfg)
    s = {"embed": ((Vp, D), "normal", 0.1 * D ** -0.5), "final_norm": ((D,), "normal", 0.1)}
    if not cfg["tie_word_embeddings"]:
        s["lm_head"] = ((D, Vp), "normal", D ** -0.5)
    if cfg["family"] == "dense":
        H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        hd, F = cfg["head_dim"], cfg["intermediate_size"]
        layer = {"ln1": ((D,), "normal", 0.1), "ln2": ((D,), "normal", 0.1),
                 "wq": ((D, H, hd), "normal", D ** -0.5),
                 "wk": ((D, K, hd), "normal", D ** -0.5),
                 "wv": ((D, K, hd), "normal", D ** -0.5),
                 "wo": ((H, hd, D), "normal", (H * hd) ** -0.5),
                 "w_gate": ((D, F), "normal", D ** -0.5),
                 "w_up": ((D, F), "normal", D ** -0.5),
                 "w_down": ((F, D), "normal", F ** -0.5)}
    elif cfg["family"] == "ssm":
        di = cfg["expand"] * D
        nh, GN, W = di // cfg["head_dim"], cfg["n_groups"] * cfg["state_size"], cfg["conv_kernel"]
        layer = {"ln": ((D,), "normal", 0.1),
                 "w_z": ((D, di), "normal", D ** -0.5), "w_x": ((D, di), "normal", D ** -0.5),
                 "w_B": ((D, GN), "normal", D ** -0.5), "w_C": ((D, GN), "normal", D ** -0.5),
                 "w_dt": ((D, nh), "normal", D ** -0.5),
                 "dt_bias": ((nh,), "dt_bias", None), "a_log": ((nh,), "a_log", None),
                 "d_skip": ((nh,), "skip", None),
                 "conv_w": ((W, di), "normal", W ** -0.5), "conv_b": ((di,), "normal", 0.1),
                 "conv_wB": ((W, GN), "normal", W ** -0.5), "conv_bB": ((GN,), "normal", 0.1),
                 "conv_wC": ((W, GN), "normal", W ** -0.5), "conv_bC": ((GN,), "normal", 0.1),
                 "norm": ((di,), "normal", 0.1),
                 "w_out": ((di, D), "normal", di ** -0.5)}
    else:
        raise ValueError(f"no weights for family {cfg['family']!r}")
    s.update({f"layers.{k}": ((L, *shape), init, scale) for k, (shape, init, scale) in layer.items()})
    return s


def draw(cfg, seed: int, device) -> dict:
    """Every weight of the model, drawn on ``device`` from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, (shape, init, scale) in sorted(specs(cfg).items()):
        if init == "normal":
            t = torch.randn(shape, generator=g, device=device, dtype=DTYPE).mul_(scale)
        else:
            u = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
            if init == "a_log":           # A = -exp(a_log) uniform in [-16, -1]
                t = torch.log(1.0 + 15.0 * u)
            elif init == "dt_bias":       # softplus(dt_bias) log-uniform in [1e-3, 1e-1]
                dt = torch.exp(math.log(1e-3) + (math.log(1e-1) - math.log(1e-3)) * u)
                t = dt + torch.log(-torch.expm1(-dt))
            else:                         # the skip weight D, about 1
                t = 1.0 + 0.2 * (u - 0.5)
            t = t.to(DTYPE)
        out[name] = t
    if cfg["family"] == "dense":
        L, D, H, hd = out["layers.wq"].shape
        K = cfg["num_key_value_heads"]
        out["layers.wq"].view(L, D, K, H // K, hd)[:, :, :, 0] = out["layers.wk"]
    return out


def port_state(cfg, w: dict) -> dict:
    """The program's parameter names (``repro_torch.models.lm.LM``) mapped to
    views of the drawn tensors."""
    groups = ({"ln1": "", "ln2": "", "wq": "attn.", "wk": "attn.", "wv": "attn.",
               "wo": "attn.", "w_gate": "mlp.", "w_up": "mlp.", "w_down": "mlp."}
              if cfg["family"] == "dense" else None)
    state = {}
    for name, t in w.items():
        if not name.startswith("layers."):
            state[name] = t
            continue
        key = name[len("layers."):]
        prefix = groups[key] if groups else ("" if key == "ln" else "mamba.")
        for i in range(t.shape[0]):
            state[f"blocks.{i}.{prefix}{key}"] = t[i]
    return state


def load_into(lm, cfg, w: dict):
    """Make the parameters of ``lm`` (built on the meta device) the drawn
    tensors.  A name or shape that does not match raises."""
    state = port_state(cfg, w)
    want = lm.state_dict()
    if set(state) != set(want):
        raise ValueError(f"weights do not match the program's parameters: missing "
                         f"{sorted(set(want) - set(state))[:5]}, extra "
                         f"{sorted(set(state) - set(want))[:5]}")
    for k, t in state.items():
        if tuple(t.shape) != tuple(want[k].shape) or t.dtype != want[k].dtype:
            raise ValueError(f"{k}: drawn {tuple(t.shape)} {t.dtype}, the program wants "
                             f"{tuple(want[k].shape)} {want[k].dtype}")
    lm.load_state_dict(state, assign=True)
