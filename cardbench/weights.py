"""Weights drawn from the seed on the device, in the type they are served in.

Each kind of weight is one tensor stacked over the layers and drawn by one
call of the card's generator, so a model takes a few dozen calls.  The same
tensors go to the program (``load_into``: its parameters become views of
them) and to the plain reference, which casts them to float32 itself.  The
whole-model tensors are drawn here; a family's module gives its layer
weights, any change after the draw and the program's names for them
(``families/__init__.py``).

Scales: each product's weight is normal with standard deviation
1/sqrt(its contraction length); norm weights and biases 0.1 x normal (the
model adds 1 to a norm weight), so every path of a layer moves the output.
The embedding is 0.1/sqrt(hidden): the model multiplies it by sqrt(hidden),
so the first layer's input has rms 0.1 and the layers, not the input
token, decide the next token (through a tied head a larger embedding makes
the model echo its input, and the served tokens then test no state).
"""
from __future__ import annotations

import torch

from cardbench import families

DTYPE = torch.bfloat16


def padded_vocab(cfg) -> int:
    return -(-cfg["vocab_size"] // 128) * 128


def stacked(L: int, layer: dict) -> dict:
    """Specs of one layer (name -> (shape, init, scale)) as tensors stacked
    over ``L`` layers, named ``"layers.<name>"``."""
    return {f"layers.{k}": ((L, *shape), init, scale) for k, (shape, init, scale) in layer.items()}


def specs(cfg) -> dict:
    """name -> (shape, init, scale).  Names without a leading "layers." are
    whole-model tensors; the others are stacked over the layers."""
    D, Vp = cfg["hidden_size"], padded_vocab(cfg)
    s = {"embed": ((Vp, D), "normal", 0.1 * D ** -0.5), "final_norm": ((D,), "normal", 0.1)}
    if not cfg["tie_word_embeddings"]:
        s["lm_head"] = ((D, Vp), "normal", D ** -0.5)
    s.update(families.module(cfg).specs(cfg))
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
            t = init(u).to(DTYPE)
        out[name] = t
    families.module(cfg).after_draw(cfg, out)
    return out


def port_state(cfg, w: dict) -> dict:
    """The program's parameter names (``repro_torch.models.lm.LM``) mapped to
    views of the drawn tensors."""
    fam = families.module(cfg)
    state = {}
    for name, t in w.items():
        if not name.startswith("layers."):
            state[name] = t
            continue
        key = name[len("layers."):]
        for i in range(t.shape[0]):
            state[fam.param_name(cfg, key, i)] = t[i]
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
