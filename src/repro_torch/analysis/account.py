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
                           kernels/flash_attention.py and kernels/ssd_scan.py;
                           K4, kernels/causal_conv.py, counts its bytes and
                           no FLOPs: its multiply-adds are elementwise, which
                           hlo.py counts none of in the jnp conv it replaces)
    * collective bytes    (per kind, max of result and operand bytes, as
                           hlo.py counts them)
    * transcendentals     (elements of exp, log, logistic, tanh, rsqrt, sqrt,
                           power, sin, cos and erf, as XLA's cost analysis
                           counts them; ``transcendentals``)
    * traffic bytes       (result plus operand bytes of every operation that
                           is not a view: eager PyTorch reads each input and
                           writes each output; an index-style in-place update
                           counts the update read and written, not the whole
                           buffer, as hlo.py counts dynamic-update-slice)

``core.scope.named_scope(tag)`` marks a region ("attention_core", "ssd_core", as
``jax.named_scope`` does in the JAX package), and the traffic of the
operations dispatched inside it is also summed by tag.  The tags reach the
backward too, as JAX's reach the transposed operations: while the account
runs, a function mode stores the scopes open in the forward on each
output's autograd node (``grad_fn.metadata["scopes"]``), and an operation
that the backward dispatches (grad mode off, an autograd node running)
takes the scopes of that node.

With ``track_memory``, the mode also follows the bytes of the tensors that
operations create and that are still alive (a finalizer on each output that
is not a view), and keeps the peak: the dry run's temporary-memory estimate.
A tensor freed while a view of it lives counts as freed.
"""
from __future__ import annotations

import math
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.overrides import TorchFunctionMode
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
# transcendental elements per output element of each op (XLA's cost
# analysis counts exp, log, log1p, expm1, logistic, tanh, rsqrt, sqrt,
# power, sin, cos and erf elements); softmax and log-sum-exp count an exp
# per input element, log_softmax and log-sum-exp a log per row
_TRANSCENDENTAL = {f: 1 for f in (
    _aten.exp.default, _aten.exp_.default, _aten.expm1.default, _aten.log.default,
    _aten.log1p.default, _aten.sigmoid.default, _aten.silu.default,
    _aten.silu_backward.default, _aten.tanh.default, _aten.rsqrt.default,
    _aten.sqrt.default, _aten.sin.default, _aten.cos.default, _aten.erf.default,
    _aten.pow.Tensor_Scalar, _aten.pow.Tensor_Tensor)}
_TRANSCENDENTAL[_aten.softplus.default] = 2          # log1p(exp(x))
_ROWWISE = {_aten._softmax.default: (1, 0), _aten._log_softmax.default: (1, 1),
            _aten.logsumexp.default: (1, 1)}
_INTEGER_POWERS = (1, 2, 3, -1, 0.5, -0.5)
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default, _aten.detach.default,
               _aten.lift_fresh.default}


def _open_scopes() -> tuple:
    """The scopes of the operation being dispatched: those open in this
    thread, or, in the backward when no traffic tag is open in this thread
    (a span such as ``decode`` may be), those of the autograd node running."""
    scopes = current_scopes()
    if torch.is_grad_enabled() or any(t in TRAFFIC_TAGS for t in scopes):
        return scopes
    node = torch._C._current_autograd_node()
    return scopes if node is None else node.metadata.get("scopes", ())


def _current_tag() -> Optional[str]:
    for tag in reversed(_open_scopes()):
        if tag in TRAFFIC_TAGS:
            return tag
    return None


class _ScopeTags(TorchFunctionMode):
    """Stores the scopes open in this thread (maybe none) on the autograd
    node of each output, and on the nodes a composite function (an einsum,
    an autograd Function) made inside the call: every node not tagged yet
    that the output's node reaches (the first scopes a node meets stay)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        scopes = current_scopes()
        stack = [t.grad_fn for t in _tensors(out)]
        while stack:
            node = stack.pop()
            if node is None or "scopes" in node.metadata:
                continue
            node.metadata["scopes"] = scopes
            stack.extend(f for f, _ in node.next_functions)
        return out


@dataclass
class StepAccount:
    flops: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    traffic_bytes: float = 0.0             # result+operand bytes estimate
    collective_ops: Dict[str, int] = field(default_factory=dict)
    traffic_by_tag: Dict[str, float] = field(default_factory=dict)
    kernel_calls: Dict[str, int] = field(default_factory=dict)
    transcendentals: float = 0.0           # elements, as XLA's cost analysis counts
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


def _kernel_transcendentals(func, args) -> float:
    """K2's exps, as the chunked scan computes them: per chunk of Q rows
    and head, the Q x Q decays, the Q decays from the chunk's start and to
    its end, and the chunk's total; K4's SiLU, one logistic a value."""
    if func._schema.name == "repro_torch::causal_conv_silu":
        return float(sum(x.numel() for x in args[0]))
    if func._schema.name != "repro_torch::ssd_scan_hmajor":
        return 0.0
    B, H, S, _ = args[0].shape
    Q = min(args[6], S)
    return float(B * H * -(-S // Q) * (Q * Q + 2 * Q + 1))


def _kernel_work(func, args):
    """(flops, bytes) of a K1, K2 or K4 call, or None."""
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
                    x_itemsize=x.element_size(), dt_itemsize=dt.element_size(),
                    Q=args[6])
    if name == "repro_torch::causal_conv_silu":      # elementwise: bytes, no FLOPs
        from repro_torch.kernels.causal_conv import work
        xs, ws = args[0], args[1]
        B, S = xs[0].shape[:2]
        return 0.0, work((B, S, sum(x.shape[2] for x in xs)), ws[0].shape[0],
                         itemsize=xs[0].element_size())[1]
    return None


def transcendentals(func, args, out) -> float:
    """Transcendental elements of one op (``_TRANSCENDENTAL``, ``_ROWWISE``;
    a power by an integer or half-integer exponent is a multiply or a
    root, which XLA rewrites before it counts)."""
    if func in _ROWWISE:
        per_elem, per_row = _ROWWISE[func]
        x = args[0]
        dim = args[1] if len(args) > 1 else -1
        dims = dim if isinstance(dim, (list, tuple)) else [dim]
        rows = x.numel() // max(1, math.prod(x.shape[d] for d in dims)) if x.dim() else 1
        return float(per_elem * x.numel() + per_row * rows)
    if func is _aten.pow.Scalar:
        # a constant base: XLA folds a constant exponent (RoPE's
        # frequencies) and counts a 0-d one (the bias corrections' step)
        return float(args[1].dim() == 0)
    n = _TRANSCENDENTAL.get(func)
    if n is None:
        return 0.0
    if func is _aten.pow.Tensor_Scalar and args[1] in _INTEGER_POWERS:
        return 0.0
    return float(n * sum(t.numel() for t in _tensors(out)))


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
            acc.transcendentals += _kernel_transcendentals(func, args)
            acc.kernel_calls[name] = acc.kernel_calls.get(name, 0) + 1
        else:
            if func in _DOTS:
                acc.flops += dot_flops(func, args)
            acc.transcendentals += transcendentals(func, args, out)
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
    with _ScopeTags(), Account(track_memory=track_memory) as acct:
        out = fn(*args, **kwargs)
    return out, acct.result
