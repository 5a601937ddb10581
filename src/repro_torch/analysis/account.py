"""Per-device accounting of one step, counted while it runs: the counterpart
of ``repro.analysis.hlo``.

The JAX package parses the SPMD-partitioned HLO of a compiled step; the
port has no HLO, so :class:`Account` is a ``TorchDispatchMode`` that counts
each operation as it is dispatched.  A DTensor operation is let through to
DTensor (the mode returns ``NotImplemented`` for it), which runs it on the
local shards: the mode then sees, and counts, the operation at the shapes
of this process's shard, and the collectives that DTensor issues at their
local payloads.  So every number is per device, as the HLO's are.  The
whole-tensor operations that DTensor runs on fake tensors to propagate
shapes are not counted.  It accumulates:

    * dot FLOPs           (2 * M * N * K for mm, addmm, bmm, baddbmm, mv, dot)
    * kernel FLOPs        (K1 and K2 count their own work: ``work`` of
                           kernels/flash_attention.py and kernels/ssd_scan.py)
    * collective bytes    (per kind, max of result and operand bytes, as
                           hlo.py counts them)
    * traffic bytes       (result plus operand bytes of every operation that
                           is not a view: eager PyTorch reads each input and
                           writes each output; an index-style in-place update
                           counts the update read and written, not the whole
                           buffer, as hlo.py counts dynamic-update-slice)

``core.scope.named_scope(tag)`` marks a region ("attention_core", "ssd_core", as
``jax.named_scope`` does in the JAX package), and the traffic of the
operations dispatched inside it is also summed by tag.  The scope covers
the forward only: the JAX package's tags also reach the backward's
transposed operations.

With ``track_memory``, the mode also follows the bytes of the tensors that
operations create and that are still alive (a finalizer on each output that
is not a view), and keeps the peak: the dry run's temporary-memory estimate.
A tensor freed while a view of it lives counts as freed.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core.scope import current_scopes

TRAFFIC_TAGS = ("attention_core", "ssd_core")

COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
}

_aten = torch.ops.aten
_DOTS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
         _aten.baddbmm.default, _aten.mv.default, _aten.dot.default}
_INDEX_UPDATES = {_aten.index_copy_.default, _aten.index_put_.default,
                  _aten.scatter_.src, _aten.scatter_add_.default,
                  _aten.index_add_.default}
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default, _aten.detach.default,
               _aten.lift_fresh.default}


def _current_tag() -> Optional[str]:
    for tag in reversed(current_scopes()):
        if tag in TRAFFIC_TAGS:
            return tag
    return None


@dataclass
class StepAccount:
    flops: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    traffic_bytes: float = 0.0             # result+operand bytes estimate
    collective_ops: Dict[str, int] = field(default_factory=dict)
    traffic_by_tag: Dict[str, float] = field(default_factory=dict)
    kernel_calls: Dict[str, int] = field(default_factory=dict)
    peak_live_bytes: float = 0.0           # with track_memory

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def dot_flops(func, args) -> float:
    """2 * M * N * K of a matrix product at its operands' shapes."""
    if func in (_aten.addmm.default, _aten.baddbmm.default):
        args = args[1:]
    a, b = args[0], args[1]
    if func is _aten.dot.default:
        return 2.0 * a.shape[0]
    if func is _aten.mv.default:
        return 2.0 * a.shape[0] * a.shape[1]
    if a.dim() == 3:                      # bmm / baddbmm
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def _kernel_work(func, args):
    """(flops, bytes) of a K1 or K2 call, or None."""
    name = func._schema.name
    if name == "repro_torch::flash_attention_hmajor":
        from repro_torch.kernels.flash_attention import work
        q, k = args[0], args[1]
        return work(tuple(q.shape), (k.shape[1], k.shape[2]), causal=args[3],
                    window=args[4], itemsize=q.element_size())
    if name == "repro_torch::ssd_scan_hmajor":
        from repro_torch.kernels.ssd_scan import work
        x, dt, B_in = args[0], args[1], args[3]
        return work(tuple(x.shape), B_in.shape[1], B_in.shape[3],
                    x_itemsize=x.element_size(), dt_itemsize=dt.element_size())
    return None


class Account(TorchDispatchMode):
    """``with Account() as acct: step()`` fills ``acct.result``."""

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self.result = StepAccount()
        self._coll_bytes: Dict[str, float] = defaultdict(float)
        self._coll_ops: Dict[str, int] = defaultdict(int)
        self._track = track_memory
        self._live = 0
        self._peak = 0

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self.result.collective_bytes = dict(self._coll_bytes)
        self.result.collective_ops = dict(self._coll_ops)
        self.result.peak_live_bytes = float(self._peak)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented            # DTensor runs it on the shards
        out = func(*args, **kwargs)
        if not any(issubclass(t, FakeTensor) for t in types):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        acc = self.result
        name = func._schema.name
        ns, _, base = name.partition("::")
        if ns in ("_c10d_functional", "_c10d_functional_autograd") and base in COLLECTIVES:
            ins, outs = _tensors((args, kwargs)), _tensors(out)
            kind = COLLECTIVES[base]
            self._coll_bytes[kind] += max(sum(map(_nbytes, outs)), sum(map(_nbytes, ins)))
            self._coll_ops[kind] += 1
            return
        if ns == "_c10d_functional":          # wait_tensor and the like
            return
        if func in _NO_TRAFFIC or func.is_view:
            return
        work = _kernel_work(func, args)
        if work is not None:
            flops, nbytes = work
            acc.flops += flops
            acc.kernel_calls[name] = acc.kernel_calls.get(name, 0) + 1
        else:
            if func in _DOTS:
                acc.flops += dot_flops(func, args)
            ins, outs = _tensors((args, kwargs)), _tensors(out)
            if func in _INDEX_UPDATES:
                nbytes = 2 * sum(map(_nbytes, ins[1:]))
            else:
                nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        acc.traffic_bytes += nbytes
        tag = _current_tag()
        if tag is not None:
            acc.traffic_by_tag[tag] = acc.traffic_by_tag.get(tag, 0.0) + nbytes
        if self._track and not func._schema.is_mutable:
            for t in _tensors(out):
                self._alloc(t)

    def _alloc(self, t):
        n = _nbytes(t)
        self._live += n
        self._peak = max(self._peak, self._live)
        weakref.finalize(t, self._free, n)

    def _free(self, n):
        self._live -= n


def account(fn, *args, track_memory: bool = False, **kwargs):
    """(fn's result, its StepAccount)."""
    with Account(track_memory=track_memory) as acct:
        out = fn(*args, **kwargs)
    return out, acct.result
