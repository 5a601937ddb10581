"""Shared primitive layers: RMSNorm, RoPE, SwiGLU MLP, parameter specs.

The PyTorch counterpart of ``repro.models.layers``.  Every parameter is
described by a :class:`ParamSpec` carrying its logical axes, from which the
sharding plan derives its placement; the same specs drive abstract
(dry-run: meta tensors, DTensors on a mesh) and concrete initialization.  Numerics follow the JAX package: norms, RoPE and the
loss compute in float32 and cast back to the input's type.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.train.tree import tree_map

DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "int8": torch.int8,
    "int32": torch.int32,
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
    return tree_map(lambda s: init_param(generator, s, device), specs)


def place(t: torch.Tensor, plan, spec) -> torch.Tensor:
    """``t`` as the plan places a tensor of PartitionSpec entries ``spec``:
    a DTensor on the plan's mesh when it is distributed (``t`` is the whole
    tensor; on the meta device nothing is allocated), else ``t`` itself."""
    if not plan.info.distributed:
        return t
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, plan.info.mesh, plan.placements_of(spec))


def abstract_tree(specs, plan):
    """Meta tensors (DTensors when the plan's mesh is distributed) for a
    ParamSpec nest: shapes, types and placements with no allocation."""
    return tree_map(lambda s: place(torch.empty(s.shape, dtype=torch_dtype(s.dtype),
                                                device="meta"),
                                    plan, plan.spec(*s.logical)), specs)


def spec_tree_partition(specs, plan):
    """PartitionSpec entries (tuples) matching a ParamSpec nest."""
    return tree_map(lambda s: plan.spec(*s.logical), specs)


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


def vocab_iota(logits):
    """arange over the vocab (last) dim of ``logits``, cut as that dim is:
    on a mesh, a replicated arange met by vocab-sharded logits would make
    DTensor gather the whole [batch, seq, vocab] logits to compare."""
    iota = torch.arange(logits.shape[-1], device=logits.device)
    if type(logits) is torch.Tensor:
        return iota
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    last = logits.dim() - 1
    return distribute_tensor(iota, logits.device_mesh,
                             [Shard(0) if p.is_shard() and p.dim == last else Replicate()
                              for p in logits.placements])


def cross_entropy_loss(logits, labels, real_vocab: int, mask=None):
    """Mean token NLL over a vocab that may be padded past ``real_vocab``.

    logits: [..., V_pad]; labels: [...] int.  Padded entries are masked to
    the finite -1e30 before the log-sum-exp.  The label's logit is a
    gather on one device.
    """
    logits = logits.float()
    iota = vocab_iota(logits)
    # masked_fill, not where with a scalar: on a mesh where's backward meets
    # the scalar as a whole replicated [batch, seq, vocab] tensor
    logits = logits.masked_fill(iota >= real_vocab, -1e30)
    if type(logits) is torch.Tensor:
        lse = torch.logsumexp(logits, dim=-1)
        nll = lse - torch.gather(logits, -1, labels[..., None].long())[..., 0]
    else:
        # a DTensor sharded on the vocab: the JAX package's one-hot
        # contraction, which stays per shard until the (tiny) reduction;
        # nll and its gradient are held cut as the logits' rows, so that the
        # gradient meets the one-hot per shard
        from torch.distributed.tensor import Partial, Replicate
        from repro_torch.sharding.plan import constrain, per_shard
        # the log-sum-exp from the row max and the row sum, each reduced
        # over the vocab shards (an all-reduce), as XLA partitions it;
        # DTensor's logsumexp would gather the whole f32 logits, and its
        # sum's backward would gather them again
        last = logits.dim() - 1
        pl = logits.placements
        rows = tuple(Replicate() if p.is_shard(last) else p for p in pl)
        row_max = torch.amax(logits, dim=-1, keepdim=True).detach()
        sums = per_shard(lambda l, m: torch.sum(torch.exp(l - m), dim=-1),
                         (pl, rows), tuple(Partial() if p.is_shard(last) else p for p in pl))(
            logits, row_max)
        lse = torch.log(sums.redistribute(sums.device_mesh, rows)) + row_max[..., 0]
        nll = lse - torch.sum(logits * (iota == labels[..., None]), dim=-1)
        nll = constrain(nll, [Replicate() if p.is_partial() or (p.is_shard() and p.dim == last)
                              else p for p in logits.placements])
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
