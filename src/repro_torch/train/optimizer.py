"""AdamW with fp32 master weights: the counterpart of ``repro.train.optimizer``.

The schedule is linear warmup -> cosine decay; gradients are clipped by
their global norm (fp32).  The state (m, v, master) is fp32, or with
``state_bits=8`` int8 m and sqrt(v) in blocks of 256 with fp32 scales
(``quantized_state``).  Every formula keeps the JAX package's order of
float32 operations, so on the same inputs the two agree to float32
rounding.

State and parameter trees are nests of tensors (``tree``), in the JAX
package's layout.  ``apply_updates_`` updates them in place, a slice of a
leaf at a time (every tree leaf contiguous), so that a step needs few
temporaries beside the state.  ``apply_updates`` keeps the JAX package's
functional form (inputs untouched, new trees returned) for the tests that
hold the two side by side; the train step calls ``apply_updates_``.

ZeRO-1: on a mesh, the fp32 state (m, v, master) is sharded over the
*data* axes in addition to the param's model-axis sharding: for each param
the first dimension that is still replicated and divides the data-axis size
(``_zero1_logical``, ``opt_state_specs``).  On DTensor leaves
``apply_updates_`` runs the same slice update on each rank's shard: the
gradient (already all-reduced over the data axes) and the param are cut to
the state's shard, and the new param is gathered back to its placement,
where XLA, in the JAX package, reduce-scatters into the state shards and
all-gathers the params.  The int8 state runs on one device only (its
blocks run over the whole flattened leaf).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.layers import ParamSpec
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


def _zero1_logical(spec: ParamSpec, plan):
    """Logical axes for the fp32 state of `spec`: first still-replicated dim
    that divides the data size is re-tagged to shard over data axes."""
    if not plan.info.data_axes:
        return spec.logical
    dsz = plan.info.data_size
    logical = list(spec.logical)
    pspec = plan.spec(*spec.logical)
    for i, (dim, ax) in enumerate(zip(spec.shape, pspec)):
        if ax is None and dim % dsz == 0 and dim >= dsz:
            logical[i] = "batch"          # "batch" maps to the data axes
            return tuple(logical)
    return spec.logical


def opt_state_specs(param_specs, plan, cfg: OptimizerConfig):
    """ParamSpec nest for the optimizer state."""
    def f32_state(s: ParamSpec):
        return ParamSpec(s.shape, _zero1_logical(s, plan), dtype="float32",
                         init="zeros")

    def q8_state(s: ParamSpec):
        nb = n_blocks(s.shape)
        scale_logical = ("blocks",) if (plan.info.num_devices > 1 and
                                        nb % plan.info.num_devices == 0) else (None,)
        return {"q": ParamSpec(s.shape, _zero1_logical(s, plan),
                               dtype="int8", init="zeros"),
                "scale": ParamSpec((nb,), scale_logical, dtype="float32",
                                   init="zeros")}

    mv_state = q8_state if cfg.state_bits == 8 else f32_state
    state = {
        "m": tree_map(mv_state, param_specs),
        "v": tree_map(mv_state, param_specs),
        "step": ParamSpec((), (), dtype="int32", init="zeros"),
    }
    if cfg.use_master:
        def master(s: ParamSpec):
            return ParamSpec(s.shape, _zero1_logical(s, plan), dtype="float32")
        state["master"] = tree_map(master, param_specs)
    return state


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


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a DTensor's whole value (a 0-d sum, a step)."""
    return t.full_tensor() if _is_dtensor(t) else t


def global_norm(tree) -> torch.Tensor:
    total = 0
    for _, leaf in items(tree):
        total = total + _whole(torch.sum(torch.square(leaf.float())))
    return torch.sqrt(total)


def _update_slice(p, g, m, v, master, m_scale, v_scale, *, cfg, lr, clip, bc1, bc2):
    """AdamW on one slice of a leaf, in place: ``m``, ``v``, ``master`` and
    ``p`` are overwritten (q8 state comes as codes with the scales of the
    slice's blocks)."""
    b1, b2 = cfg.beta1, cfg.beta2
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


def _update_leaf(p, g, m, v, master, **hyper):
    """``_update_slice`` over a leaf, ``_SLICE`` elements at a time (plain
    tensors, contiguous but for ``g``)."""
    q8 = isinstance(m, dict)
    flat = [t.reshape(-1) if t is g else t.view(-1) if t is not None else None
            for t in (p, g, m["q"] if q8 else m, v["q"] if q8 else v, master)]
    for s in range(0, p.numel(), _SLICE):
        e = min(s + _SLICE, p.numel())
        blocks = slice(s // BLOCK, -(-e // BLOCK))
        _update_slice(*(t if t is None else t[s:e] for t in flat),
                      m["scale"][blocks] if q8 else None, v["scale"][blocks] if q8 else None,
                      **hyper)


def _update_sharded(p, g, m, v, master, **hyper):
    """``_update_leaf`` on DTensors, on this rank's ZeRO-1 shard: the
    gradient (replicated over the data axes) and the param are cut to the
    state's placements, the shard is updated, and the new param is
    gathered back to its own placement, where XLA, in the JAX package,
    reduce-scatters into the state shards and all-gathers the params."""
    if isinstance(m, dict):
        raise NotImplementedError("the int8 optimizer state runs on one device only")
    mesh, pl = m.device_mesh, m.placements
    local = p.redistribute(mesh, pl)
    _update_leaf(local.to_local(), g.redistribute(mesh, pl).to_local(), m.to_local(),
                 v.to_local(), None if master is None else master.to_local(), **hyper)
    if tuple(pl) != tuple(p.placements):
        p.copy_(local.redistribute(p.device_mesh, p.placements))


@torch.no_grad()
def apply_updates_(params, grads, opt_state, cfg: OptimizerConfig):
    """One AdamW step in place: ``params`` (any float type), ``opt_state``
    and its step counter are overwritten; ``grads`` (fp32, or cast here)
    are read.  The leaves are plain tensors, or on a mesh DTensors: params
    placed by the plan, grads in the params' placements, the state in the
    ZeRO-1 placements of ``opt_state_specs`` (f32 only).  Returns the
    metrics {"lr", "grad_norm"}."""
    step = opt_state["step"] + 1
    stepf = _whole(step).float()
    lr = schedule(stepf, cfg)
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
            if cfg.clip_norm > 0 else 1.0)
    hyper = dict(cfg=cfg, lr=lr, clip=clip, bc1=1 - torch.pow(cfg.beta1, stepf),
                 bc2=1 - torch.pow(cfg.beta2, stepf))
    masters = opt_state.get("master")

    def upd(p, g, m, v, master):
        (_update_sharded if _is_dtensor(p) else _update_leaf)(p, g, m, v, master, **hyper)

    tree_map(upd, params, grads, opt_state["m"], opt_state["v"],
             masters if masters is not None else tree_map(lambda p: None, params))
    opt_state["step"] = step
    return {"lr": lr, "grad_norm": gnorm}


def apply_updates(params, grads, opt_state, cfg: OptimizerConfig):
    """One AdamW step, functional as the JAX package's: returns
    (new_params, new_opt_state, metrics) and leaves its inputs untouched.
    It clones both trees, so it is the parity tests' form; training steps
    in place with ``apply_updates_``."""
    params, opt_state = (tree_map(lambda t: t.detach().clone(), tree)
                         for tree in (params, opt_state))
    metrics = apply_updates_(params, grads, opt_state, cfg)
    return params, opt_state, metrics
