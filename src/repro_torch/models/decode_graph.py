"""A decode step replayed as one CUDA graph, in place of its launches from Python.

``LM.decode`` asks :func:`decode_graph_refusal` whether a step may run as a
graph.  Where it finds nothing against it, the model's first decode runs
the graph's program eagerly (lazy initialisation happens outside a
capture), and then the first call with a new cache captures the step on
that cache's own tensors and replays it; later calls with the same cache
replay.  A graph is keyed on the identity of the cache's tensors (pointer,
shape, strides, dtype) and the token's shape, and is released when one of
those tensors is freed: no graph outlives its batch, and no copy of a cache
or a state is kept.  Each graph is captured into a memory pool of its own,
which goes with it, on the one capture stream of its device (a stream
gets a cuBLAS workspace of its own, kept for the process).  The caching
allocator cannot hand its cached blocks back to the device while a capture
runs, so a capture that starts with less than ``CAPTURE_HEADROOM`` free on
the device (a long prefill's temporaries left cached, as at granite-4.0-h-
small's 4 x 32k prefills) hands them back first.

The step reads its position from one int64 on the device, which the host
writes before each replay (it still checks the int against the cache's
length): RoPE's positions, the cache write's index and K3's valid length
take it from there (``models/lm.py``, ``models/attention.py``).  The token
is copied into the graph's own input; the logits come back cloned, so that
a caller holds them as it would an eager step's.

The kernels' launch counters (K1, K2, K3) count their wrappers' calls,
eager and captured; a replay calls no wrapper.  ``COUNTS`` holds the
process's decode steps by how they ran: ``capture``, ``replay`` or
``eager``.  Nothing here is a setting: the rule reads the inputs.
"""
from __future__ import annotations

import operator
import weakref

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.kernels.decode_attention import HEAD_DIMS as K3_HEAD_DIMS
from repro_torch.models.moe import SLOT_TOKENS

COUNTS = {"capture": 0, "replay": 0, "eager": 0}
CAPTURE_HEADROOM = 8 << 30      # bytes free on the device below which a capture empties the cache
_STREAMS: dict = {}     # device index -> the stream every capture there runs on


def cache_leaves(cache) -> list:
    """The tensors of a decode cache (a nest of dicts), in order."""
    if isinstance(cache, dict):
        return [t for v in cache.values() for t in cache_leaves(v)]
    return [cache]


def _kv_caches(lm, cache) -> list:
    """The attention caches ({"k", "v", ...}) of a decode cache."""
    if lm.cfg.family == "ssm":
        return []
    if lm.cfg.family == "hybrid":
        return [cache["attn"]]
    if lm.cfg.encoder is not None:
        return [cache["self"], cache["cross"]]
    return [cache]


def decode_graph_refusal(lm, cache, token) -> str | None:
    """Why ``lm.decode`` does not run this step as a CUDA graph, or None when
    it does.  A rule on the inputs alone, as ``attention.k3_refusal`` is:
    plain tensors (not DTensors) on a CUDA card, no mesh, no gradient wanted,
    no dispatch mode active (``analysis.account`` counts while eager ops
    run), no quantisation scales in the cache, every attention layer of the
    step one that K3 takes with no window (a bf16 or f16 cache of the
    activations' type at a head dim K3 instantiates), and no op that the
    host reads: a held MoE above ``moe.SLOT_TOKENS`` tokens takes the sorted
    layout, whose expert counts the host reads."""
    leaves = [token, *cache_leaves(cache)]
    if not all(type(t) is torch.Tensor for t in leaves):
        return "a DTensor or another tensor subclass"
    if lm.distributed:
        return "a mesh"
    if torch.is_grad_enabled() and any(t.requires_grad for t in [*leaves, *lm.parameters()]):
        return "a gradient"
    if _get_current_dispatch_mode() is not None:
        return "a dispatch mode"
    if lm.cfg.moe is not None and lm.cfg.moe.held and token.numel() > SLOT_TOKENS:
        return "a host read in the MoE dispatch"
    kvs = _kv_caches(lm, cache)
    if any("k_scale" in kv for kv in kvs):
        return "a quantized cache"
    if kvs and lm.cfg.family != "hybrid" and any(
            (lm._layer_window(i)[0] or 0) > 0 for i in range(lm.cfg.num_layers)):
        return "a windowed layer"
    act = lm.embed.dtype
    if any(kv["k"].dtype != act or act not in (torch.bfloat16, torch.float16)
           or kv["k"].shape[-1] not in K3_HEAD_DIMS for kv in kvs):
        return "an attention layer that K3 does not take"
    if not all(t.is_cuda for t in leaves):
        return "not on a CUDA card"
    return None


def _check_pos(lm, cache, pos) -> int:
    """``pos`` as an int, inside the self-attention cache's length."""
    pos = operator.index(pos)
    kvs = _kv_caches(lm, cache)
    length = kvs[0]["k"].shape[2] if kvs else None
    if pos < 0 or (length is not None and pos >= length):
        raise ValueError(f"decode position {pos} outside the cache's {length} positions")
    return pos


def _key(cache, token) -> tuple:
    return (tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                  for t in cache_leaves(cache)), tuple(token.shape), token.dtype)


class _Graph:
    __slots__ = ("graph", "token", "pos", "logits")


def _drop(graphs, key, entry_id):
    if id(graphs.get(key)) == entry_id:
        del graphs[key]


class DecodeGraphs:
    """One model's decode graphs, by the identity of their caches."""

    def __init__(self):
        self._graphs: dict = {}
        self._warm = False

    def __len__(self):
        return len(self._graphs)

    def step(self, lm, cache, token, pos):
        """(logits [B,1,V_pad], how the step ran, why it ran eagerly or
        None) of one decode step through a graph."""
        pos = _check_pos(lm, cache, pos)
        if not self._warm:
            self._warm = True
            at = torch.full((1,), pos, dtype=torch.long, device=token.device)
            return lm._step(cache, token, at), "eager", "the model's first decode step"
        key = _key(cache, token)
        g = self._graphs.get(key)
        how = "replay"
        if g is None:
            g, how = self._capture(lm, cache, token, key), "capture"
        g.pos.fill_(pos)
        g.token.copy_(token)
        g.graph.replay()
        return g.logits.clone(), how, None

    def _capture(self, lm, cache, token, key) -> _Graph:
        dev = token.device
        i = dev.index if dev.index is not None else torch.cuda.current_device()
        if i not in _STREAMS:
            _STREAMS[i] = torch.cuda.Stream(dev)
        g = _Graph()
        with torch.inference_mode(False):    # inputs a later call may write outside it
            g.token = torch.zeros_like(token)
            g.pos = torch.zeros(1, dtype=torch.long, device=dev)
        g.graph = torch.cuda.CUDAGraph()
        if torch.cuda.mem_get_info(dev)[0] < CAPTURE_HEADROOM:
            torch.cuda.empty_cache()
        stream, here = _STREAMS[i], torch.cuda.current_stream(dev)
        stream.wait_stream(here)
        with torch.cuda.stream(stream):
            g.graph.capture_begin(capture_error_mode="thread_local")
            try:
                g.logits = lm._step(cache, g.token, g.pos)
            finally:
                g.graph.capture_end()
        here.wait_stream(stream)
        self._keep(key, g, cache)
        return g

    def _keep(self, key, g, cache):
        """Keep ``g`` under ``key`` until one of the cache's tensors is freed."""
        self._graphs[key] = g
        for t in cache_leaves(cache):
            weakref.finalize(t, _drop, self._graphs, key, id(g)).atexit = False
