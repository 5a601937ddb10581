"""AdamW with fp32 master weights: the counterpart of ``repro.train.optimizer``
on one device.

The schedule is linear warmup -> cosine decay; gradients are clipped by
their global norm (fp32).  The state (m, v, master) is fp32, or with
``state_bits=8`` int8 m and sqrt(v) in blocks of 256 with fp32 scales
(``quantized_state``).  Every formula keeps the JAX package's order of
float32 operations, so on the same inputs the two agree to float32
rounding.  The ZeRO-1 sharding of the state over data axes comes with the
sharding slice.

State and parameter trees are nested dicts of tensors (``tree``), in the
JAX package's layout.  ``apply_updates_`` updates them in place, a slice
of a leaf at a time (every tree leaf contiguous), so that a step needs
few temporaries beside the state.  ``apply_updates`` keeps the JAX
package's functional form (inputs untouched, new trees returned) for the
tests that hold the two side by side; the train step calls
``apply_updates_``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.train.quantized_state import BLOCK, n_blocks, q8_decode, q8_encode
from repro_torch.train.tree import items, tree_map


# elements of a leaf updated at a time (a multiple of BLOCK, so that a slice
# holds whole int8 blocks): the update's temporaries stay ~10 x 64 MB
# whatever the largest leaf, where XLA fuses them away
_SLICE = 1 << 24


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0
    use_master: bool = True
    # 8 = block-wise int8 m/v (8-bit Adam, ~6 B/param with fp32 master
    # instead of 12)
    state_bits: int = 32


def schedule(step, cfg: OptimizerConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), float32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * warm * decay


def init_opt_state(params, cfg: OptimizerConfig):
    """Concrete zero state (master initialized from params)."""
    def zeros(p):
        if cfg.state_bits == 8:
            return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                    "scale": torch.zeros((n_blocks(p.shape),), device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = items(params)[0][1].device
    state = {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.use_master:
        state["master"] = tree_map(lambda p: p.detach().float().clone(), params)
    return state


def global_norm(tree) -> torch.Tensor:
    total = 0
    for _, leaf in items(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates_(params, grads, opt_state, cfg: OptimizerConfig):
    """One AdamW step in place: ``params`` (any float type), ``opt_state``
    and its step counter are overwritten; ``grads`` (fp32, or cast here)
    are read.  Returns the metrics {"lr", "grad_norm"}."""
    step = opt_state["step"] + 1
    lr = schedule(step, cfg)
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
            if cfg.clip_norm > 0 else 1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    masters = opt_state.get("master")

    def upd_slice(p, g, m, v, master, m_scale, v_scale):
        """One slice of a leaf; q8 state comes as codes with the scales of
        the slice's blocks."""
        q8 = m_scale is not None
        if q8:
            m_f = q8_decode(m, m_scale)
            # v is stored as sqrt(v): int8 absmax quantization in the linear
            # domain zeroes small second moments and destabilizes Adam
            v_f = torch.square(q8_decode(v, v_scale))
        else:
            m_f, v_f = m, v
        g = g.float() * clip
        m_f = b1 * m_f + (1 - b1) * g
        v_f = b2 * v_f + (1 - b2) * torch.square(g)
        mhat, vhat = m_f / bc1, v_f / bc2
        base = master if master is not None else p.float()
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * base
        new_master = base - lr * delta
        if q8:
            for codes, scale, value in ((m, m_scale, m_f), (v, v_scale, torch.sqrt(v_f))):
                q, sc = q8_encode(value)
                codes.copy_(q)
                scale.copy_(sc)
        else:
            m.copy_(m_f)
            v.copy_(v_f)
        if master is not None:
            master.copy_(new_master)
        p.copy_(new_master.to(p.dtype))

    def upd(p, g, m, v, master):
        q8 = isinstance(m, dict)
        flat = [t.view(-1) if t is not None else None
                for t in (p, g, m["q"] if q8 else m, v["q"] if q8 else v, master)]
        for s in range(0, p.numel(), _SLICE):
            e = min(s + _SLICE, p.numel())
            blocks = slice(s // BLOCK, -(-e // BLOCK))
            upd_slice(*(t if t is None else t[s:e] for t in flat),
                      m["scale"][blocks] if q8 else None, v["scale"][blocks] if q8 else None)

    tree_map(upd, params, grads, opt_state["m"], opt_state["v"],
             masters if masters is not None else tree_map(lambda p: None, params))
    opt_state["step"] = step
    return {"lr": lr, "grad_norm": gnorm}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def apply_updates(params, grads, opt_state, cfg: OptimizerConfig):
    """One AdamW step, functional as the JAX package's: returns
    (new_params, new_opt_state, metrics) and leaves its inputs untouched.
    It clones both trees, so it is the parity tests' form; training steps
    in place with ``apply_updates_``."""
    params, opt_state = _clone(params), _clone(opt_state)
    metrics = apply_updates_(params, grads, opt_state, cfg)
    return params, opt_state, metrics
