"""Shared primitive layers: RMSNorm, RoPE, SwiGLU MLP, parameter specs.

The PyTorch counterpart of ``repro.models.layers``.  Every parameter is
described by a :class:`ParamSpec` carrying its logical axes; the same specs
drive initialization.  Numerics follow the JAX package: norms, RoPE and the
loss compute in float32 and cast back to the input's type.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "int8": torch.int8,
}


def torch_dtype(name) -> torch.dtype:
    """Map a dtype name of the configs (``"bfloat16"``, ...) to torch's."""
    if isinstance(name, torch.dtype):
        return name
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(DTYPES)}")
    return DTYPES[name]


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    logical: tuple              # logical axis names, len == len(shape)
    dtype: str = "bfloat16"
    init: str = "normal"        # normal | zeros | ones


def init_param(generator: torch.Generator, spec: ParamSpec, device) -> torch.Tensor:
    """Draw one parameter on ``device`` from ``generator`` (same device)."""
    dtype = torch_dtype(spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "ssm_a":
        # A in [-16, -1]: negative per-head decay rates
        lo, hi = 1.0, 16.0
        u = torch.rand(spec.shape, generator=generator, dtype=torch.float32, device=device)
        return (-(lo + (hi - lo) * u)).to(dtype)
    if spec.init == "ssm_dt":
        # dt_bias = softplus^-1(dt), log(dt) ~ uniform(log 1e-3, log 1e-1)
        u = torch.rand(spec.shape, generator=generator, dtype=torch.float32, device=device)
        dt = torch.exp(math.log(1e-3) + (math.log(1e-1) - math.log(1e-3)) * u)
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    if spec.init != "normal":
        raise ValueError(f"unknown init {spec.init!r}")
    # fan-in normal init, as the JAX package draws it
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


def init_tree(generator: torch.Generator, specs, device):
    """Initialize a nest (dicts and lists) of ParamSpec into tensors, drawing
    the leaves in traversal order (dict keys sorted, as jax flattens)."""
    if isinstance(specs, ParamSpec):
        return init_param(generator, specs, device)
    if isinstance(specs, dict):
        return {k: init_tree(generator, specs[k], device) for k in sorted(specs)}
    if isinstance(specs, (list, tuple)):
        return [init_tree(generator, s, device) for s in specs]
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


# ---------------------------------------------------------------- numerics
def rms_norm(x, weight, eps: float):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exponent)


def apply_rope(x, positions, theta: float):
    """x: [..., seq, heads, head_dim]; positions: [..., seq].  Split halves,
    not interleaved."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)                  # [hd/2]
    ang = positions[..., :, None].float() * inv                   # [..., seq, hd/2]
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP.  x: [..., D]; w_gate/w_up [D, F]; w_down [F, D]."""
    h_g = x @ w_gate
    h_u = x @ w_up
    h = F.silu(h_g.float()).to(x.dtype) * h_u
    return h @ w_down


def cross_entropy_loss(logits, labels, real_vocab: int, mask=None):
    """Mean token NLL over a vocab that may be padded past ``real_vocab``.

    logits: [..., V_pad]; labels: [...] int.  Padded entries are masked to
    the finite -1e30 before the log-sum-exp.
    """
    logits = logits.float()
    iota = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(iota < real_vocab, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - label_logit
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
