"""Logical-axis -> mesh-axis sharding rules with divisibility fallbacks: the
counterpart of ``repro.sharding.plan``.

The production mesh is ``(data=16, model=16)`` per pod and
``(pod=2, data=16, model=16)`` across pods (see launch/mesh.py).  Logical
axes:

    batch      -> (pod, data)          activations / caches
    seq        -> None (training/prefill); model or (pod,data,model) for
                  decode KV caches (flash-decode style partial softmax)
    embed      -> None                  (activations keep d_model replicated)
    q_heads    -> model  (padded to a multiple of |model| - Megatron pads)
    kv_heads   -> model if divisible after padding policy, else replicated
    head_dim   -> None
    mlp        -> model                 (Megatron FFN TP)
    vocab      -> model  (padded to a multiple of |model| * 128)
    experts    -> model                 (expert parallelism)
    ssm_heads  -> model                 (SSD heads are embarrassingly TP)
    d_inner    -> model                 (mamba channel dim)
    layers / state / conv / expert_mlp -> None

``spec`` gives, per tensor dim, what JAX's ``PartitionSpec`` holds: None,
a mesh-axis name, or a tuple of names (a one-name tuple is the name, as
JAX normalises it).  ``placements`` turns that into DTensor placements, one
per mesh dim: a tensor dim sharded over ("pod", "data") takes ``Shard(d)``
on both mesh dims, in mesh order, as JAX shards it major to minor.

The mesh is a ``DeviceMesh`` (more than one device: the model holds
DTensors placed by these rules) or a device-less ``AbstractMesh`` (one
device, or the rules alone).  ``make_plan(cfg)`` with no mesh is the 1x1
("data", "model") plan of JAX's ``single_device_mesh``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class AbstractMesh:
    """A device-less mesh: axis sizes and names only, which is all the
    sharding plan's rules read (JAX's ``AbstractMesh``).  ``device_type``
    names where a one-device mesh runs."""
    axis_sizes: tuple
    axis_names: tuple
    device_type: str = "cpu"

    @property
    def shape(self) -> dict:
        """{axis name: size}, as JAX's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_abstract_mesh(shape, axes, device_type: str = "cpu") -> AbstractMesh:
    return AbstractMesh(tuple(shape), tuple(axes), device_type)


# replicated kv params bigger than this get padded+sharded instead
_KV_REPLICATE_BYTES_LIMIT = 512 * 1024 * 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _norm(entry):
    """A spec entry as JAX normalises it: () -> None, (name,) -> name."""
    if isinstance(entry, tuple):
        if not entry:
            return None
        if len(entry) == 1:
            return entry[0]
    return entry


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class MeshInfo:
    mesh: object                # DeviceMesh or AbstractMesh
    sizes: tuple                # ((axis name, size), ...) in mesh order
    data_axes: tuple            # ("pod","data") or ("data",) or ()
    model_axis: Optional[str]   # "model" or None (single device)

    @property
    def shape(self) -> dict:
        return dict(self.sizes)

    @property
    def axis_names(self) -> tuple:
        return tuple(n for n, _ in self.sizes)

    @property
    def model_size(self) -> int:
        return self.shape[self.model_axis] if self.model_axis else 1

    @property
    def data_size(self) -> int:
        return math.prod(self.shape[a] for a in self.data_axes)

    @property
    def num_devices(self) -> int:
        return self.model_size * self.data_size

    @property
    def distributed(self) -> bool:
        """True when the mesh is a DeviceMesh of more than one device: the
        model's tensors are DTensors on it."""
        return not isinstance(self.mesh, AbstractMesh) and math.prod(
            s for _, s in self.sizes) > 1

    @classmethod
    def from_mesh(cls, mesh) -> "MeshInfo":
        if isinstance(mesh, AbstractMesh):
            names, sizes = mesh.axis_names, mesh.axis_sizes
        else:                                     # torch DeviceMesh
            names, sizes = tuple(mesh.mesh_dim_names), tuple(mesh.shape)
        model = "model" if "model" in names else None
        data = tuple(a for a in names if a in ("pod", "data"))
        return cls(mesh=mesh, sizes=tuple(zip(names, sizes)), data_axes=data,
                   model_axis=model)


@dataclass(frozen=True)
class ShardingPlan:
    info: MeshInfo
    cfg: ModelConfig
    # padded dims (== cfg dims on a 1-wide model axis)
    H: int                      # padded q heads
    K: int                      # padded kv heads
    V: int                      # padded vocab
    kv_sharded: bool            # kv_heads -> model?
    head_pad_overhead: float    # extra attention FLOP fraction from padding
    # FSDP/ZeRO-3: weights' embed dim additionally sharded over the data
    # axes (gathered per layer at use).  Enabled when one model-axis shard
    # of the params would not fit HBM (>= ~35B-param archs on a 16-wide
    # model axis).  Activations are unaffected: the spec() dedupe drops the
    # data axes on any tensor whose batch dim already owns them.
    fsdp: bool = False

    # ------------------------------------------------------------- specs
    def _axis(self, logical: Optional[str]):
        m = self.info.model_axis
        d = self.info.data_axes
        table = {
            "batch": d if d else None,
            "seq": None,
            "embed": (d if (self.fsdp and d) else None),
            "q_heads": m,
            "kv_heads": m if self.kv_sharded else None,
            "head_dim": None,
            "mlp": m,
            "vocab": m,
            "experts": m,
            "expert_mlp": None,
            "ssm_heads": m,
            "d_inner": m,
            "layers": None,
            "groups": None,
            "state": None,
            "conv": None,
            "scalar": None,
            # flat per-block quantization scales: shard over every axis
            "blocks": (tuple(d) + ((m,) if m else ())) or None,
            None: None,
        }
        return table[logical]

    def spec(self, *logical: Optional[str]) -> tuple:
        """The PartitionSpec entries of a tensor with these logical axes."""
        axes = [self._axis(name) for name in logical]
        # a mesh axis may appear at most once in a spec
        seen: set = set()
        out = []
        for a in axes:
            names = _names(a)
            if any(n in seen for n in names):
                out.append(None)
            else:
                seen.update(names)
                out.append(_norm(a))
        return tuple(out)

    def placements_of(self, spec) -> tuple:
        """DTensor placements (one per mesh dim) of spec entries."""
        from torch.distributed.tensor import Replicate, Shard
        index = {name: i for i, name in enumerate(self.info.axis_names)}
        out = [Replicate()] * len(index)
        for dim, entry in enumerate(spec):
            for name in _names(entry):
                out[index[name]] = Shard(dim)
        return tuple(out)

    def placements(self, *logical: Optional[str]) -> tuple:
        return self.placements_of(self.spec(*logical))

    # cache specs -----------------------------------------------------------
    def kv_cache_spec(self, batch: int) -> tuple:
        """[layers, 2, batch, seq, kv_heads, head_dim] decode cache.

        batch -> data axes when it divides; kv_heads -> model when sharded;
        otherwise shard seq over the leftover axes (flash-decode layout).
        """
        d, m = self.info.data_axes, self.info.model_axis
        batch_ax = d if (d and batch % self.info.data_size == 0) else None
        leftover = [] if batch_ax else list(d)
        if self.kv_sharded:
            kv_ax, seq_ax = m, (tuple(leftover) or None)
        else:
            kv_ax = None
            seq_ax = tuple(leftover + ([m] if m else [])) or None
        return tuple(_norm(a) for a in (None, None, batch_ax, seq_ax, kv_ax, None))

    def ssm_cache_spec(self, batch: int) -> tuple:
        """[layers, batch, ssm_heads, head_dim, state] decode state."""
        d = self.info.data_axes
        batch_ax = d if (d and batch % self.info.data_size == 0) else None
        return tuple(_norm(a) for a in (None, batch_ax, self._axis("ssm_heads"), None, None))

    def conv_cache_spec(self, batch: int) -> tuple:
        """[layers, batch, conv_width-1, conv_channels]."""
        d = self.info.data_axes
        batch_ax = d if (d and batch % self.info.data_size == 0) else None
        return tuple(_norm(a) for a in (None, batch_ax, None, self._axis("d_inner")))

    def act(self, x, *logical):
        """Sharding constraint by logical axes: a DTensor is redistributed to
        the placements of ``logical``, and so is its gradient (JAX's
        with_sharding_constraint, whose transpose constrains the cotangent
        alike); a plain tensor, on one device, is left as it is."""
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        return constrain(x, self.placements_of(self.divisible(x.shape, self.spec(*logical))))

    def divisible(self, shape, spec) -> tuple:
        """``spec`` with every dim whose size its mesh axes do not divide left
        replicated (XLA pads such a dim instead; DTensor's uneven shards
        cannot be reshaped)."""
        sizes = self.info.shape
        return tuple(None if dim % math.prod(sizes[n] for n in _names(entry)) else entry
                     for dim, entry in zip(shape, spec))


def per_shard(fn, in_placements, out_placements, mesh=None):
    """``fn`` run on this rank's local shards, as JAX's ``shard_map`` runs a
    function per shard.  Each argument is brought to its entry of
    ``in_placements`` (a DTensor redistributed, a whole tensor distributed)
    and handed over as its local tensor; an entry of None passes the
    argument as it is (a number, None).  Each output becomes a DTensor
    placed by ``out_placements`` (one tuple of placements, or one per output
    when ``fn`` returns a tuple) on the arguments' mesh, or ``mesh``.  The
    shards are even (``ShardingPlan.divisible``), so each output's global
    shape follows from its local one.  An argument whole over a mesh dim
    that cuts an output takes, in the backward, the sum of the shards'
    gradients (each shard's is a part: a Partial gradient)."""
    from torch.distributed.tensor import DTensor, Partial, distribute_tensor
    outs = out_placements if isinstance(out_placements[0], tuple) else (out_placements,)
    cut = [any(not o[i].is_replicate() for o in outs) for i in range(len(outs[0]))]

    def run(*args):
        m = mesh or next(a.device_mesh for a in args if isinstance(a, DTensor))

        def local(a, pl):
            if pl is None or a is None:
                return a
            a = a.redistribute(m, pl) if isinstance(a, DTensor) else distribute_tensor(a, m, pl)
            return _ContiguousGrad.apply(a.to_local(
                grad_placements=[Partial() if c and p.is_replicate() else p
                                 for p, c in zip(pl, cut)]))

        def wrap(t, pl):
            return DTensor.from_local(t.contiguous(), m, pl, run_check=False)

        out = fn(*(local(a, pl) for a, pl in zip(args, in_placements, strict=True)))
        if isinstance(out, tuple):
            return tuple(wrap(t, pl) for t, pl in zip(out, out_placements, strict=True))
        return wrap(out, out_placements)
    return run


def model_cut(t, dim, gather: bool = False):
    """``t`` with its placement on the mesh's "model" axis made Shard(dim)
    (Replicate when ``dim`` is None) and, with ``gather``, every other
    mesh axis that cuts ``dim`` made Replicate; ``t`` itself when it is not
    a DTensor, its mesh has no model axis or that axis does not divide the
    dim."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor) or "model" not in (t.device_mesh.mesh_dim_names or ()):
        return t
    i = t.device_mesh.mesh_dim_names.index("model")
    if dim is not None and t.shape[dim] % t.device_mesh.size(i):
        return t
    pl = [(Replicate() if dim is None else Shard(dim)) if j == i else
          (Replicate() if gather and p.is_shard(dim) else p)
          for j, p in enumerate(t.placements)]
    return t.redistribute(t.device_mesh, pl)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: a local gradient
    laid out by a permute (``movedim``) would meet, once wrapped as a
    DTensor, a reshape that DTensor reckons a view of it."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def constrain(x, placements):
    """``x`` (a DTensor) redistributed to ``placements``, and its gradient
    to the same placements."""
    return _Constrain.apply(x, tuple(placements))


def _constrain(x, placements):
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


class _Constrain(torch.autograd.Function):
    """Redistribute forward and backward to the same placements.  DTensor's
    own redistribute gives the gradient the input's placements back, so a
    sub-layer output reduced from Partial would pass a Partial gradient on,
    which the products before it can only meet by gathering weights."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return _constrain(x, placements)

    @staticmethod
    def backward(ctx, grad):
        # the local shard made contiguous: a gradient laid out by a permuted
        # product can meet a reshape that DTensor reckons, from the global
        # strides, a view of it
        from torch.distributed.tensor import DTensor
        grad = _constrain(grad, ctx.placements)
        return DTensor.from_local(grad.to_local().contiguous(), grad.device_mesh,
                                  grad.placements, run_check=False, shape=grad.shape,
                                  stride=grad.stride()), None


def make_plan(cfg: ModelConfig, mesh=None) -> ShardingPlan:
    """The plan of ``cfg`` on ``mesh`` (a DeviceMesh or an AbstractMesh);
    no mesh is the 1x1 ("data", "model") mesh."""
    info = MeshInfo.from_mesh(mesh if mesh is not None else single_device_mesh())
    m = info.model_size
    if cfg.num_heads == 0:                      # attention-free (pure SSM)
        H = K = 0
        kv_sharded = False
        overhead = 0.0
    else:
        H = _round_up(cfg.num_heads, m)
        # keep GQA grouping valid: H must be a multiple of K
        K = cfg.num_kv_heads
        if H % K != 0:
            K = _smallest_divisor_geq(H, K)
        kv_sharded = K % m == 0
        if not kv_sharded:
            # decide replicate vs pad+shard by replicated byte cost
            attn_layers = sum(1 for i in range(cfg.num_layers) if cfg.is_attn_layer(i))
            rep_bytes = 2 * cfg.d_model * K * cfg.head_dim * attn_layers * 2
            K_pad = _round_up(K, m)
            if rep_bytes > _KV_REPLICATE_BYTES_LIMIT and H % K_pad == 0:
                K, kv_sharded = K_pad, True
        overhead = H / cfg.num_heads - 1.0
    V = _round_up(cfg.vocab_size, max(m * 128, 128))
    # FSDP threshold: one model-axis shard of the bf16 params > 4 GiB
    shard_bytes = 2 * cfg.param_count() / max(m, 1)
    fsdp = bool(info.data_axes) and shard_bytes > 4 * 2**30
    return ShardingPlan(info=info, cfg=cfg, H=H, K=K, V=V,
                        kv_sharded=kv_sharded, head_pad_overhead=overhead,
                        fsdp=fsdp)


def _smallest_divisor_geq(n: int, k: int) -> int:
    """smallest divisor of n that is >= k (exists: n itself)."""
    for d in range(k, n + 1):
        if n % d == 0:
            return d
    return n


def single_device_mesh(device_type: str = "cpu") -> AbstractMesh:
    """1x1 (data, model) mesh."""
    return make_abstract_mesh((1, 1), ("data", "model"), device_type)
