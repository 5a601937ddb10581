"""Named scopes: a per-thread stack of tags pushed around a region of code
(``named_scope("attention_core")``), as ``jax.named_scope`` names a region
of the JAX package's HLO, and the port's span recorder.

The models mark their regions and layer boundaries with it;
``analysis.account`` reads the stack to sum the traffic of a step by tag.
Outside a profiler a scope pushes and pops its tag and reads one
thread-local flag.

While a ``torch.profiler`` session is active (checked once, when the
outermost scope of the thread opens) every scope is also a span: it opens a
``torch.profiler.record_function(tag)``, so that the profiler's export shows
the program's regions on the kernels' timeline, stamps its start and end
with ``time.time_ns()`` inside that range, and on exit appends a
:class:`Span` to a bounded process-wide list (:func:`spans`).
``time.time_ns()`` is CLOCK_REALTIME, the clock of the profiler's events,
so a span can be laid beside the device's operations (:func:`attribute`).
A span never synchronises the card.  Attributes (``named_scope("decode",
pos=7)``, or ``scope.note(...)`` while ``scope.recording``) are kept only
on recorded spans; compute the costly ones only while recording.  A count
that lives on the device is noted with ``scope.note_later(...)`` and read
by the host at :func:`settle`, which runs when the thread's outermost scope
closes and which ``LM.decode`` calls after its step: a CUDA graph being
captured allows no read by the host, and its values exist only once the
graph has run.
"""
from __future__ import annotations

import bisect
import itertools
import threading
import time
from collections import defaultdict, namedtuple

from torch.autograd import DeviceType, _profiler_enabled
from torch.autograd.profiler import record_function

MAX_SPANS = 1 << 18

Span = namedtuple("Span", "tag id parent start_ns end_ns attrs")
Span.__doc__ = """A closed scope: ``parent`` is the id of the recorded
scope it was opened in (0 at the root); times in ns of CLOCK_REALTIME."""


class _State(list):
    """One thread's open tags, outermost first, its recording flag and its
    open spans."""
    __slots__ = ("on", "open")

    def __init__(self):
        super().__init__()
        self.on = False          # recording, decided by the outermost scope
        self.open = []           # (tag, id, parent, attrs, range, start) of each open span


_local = threading.local()
_spans: list = []
_dropped = [0]
_ids = itertools.count(1)
_plain: dict = {}
_pending: list = []      # (attrs, {name: device tensor}, finish) of notes not yet read


def _state() -> _State:
    _local.state = st = _State()
    return st


class _Scope:
    __slots__ = ("tag", "attrs")

    def __init__(self, tag, attrs):
        self.tag = tag
        self.attrs = attrs

    @property
    def recording(self) -> bool:
        """Is this scope a span (valid inside its ``with``)?"""
        return _local.state.on

    def note(self, **attrs):
        """Add attributes to this span, the innermost open span of its tag
        (call only while ``recording``)."""
        for tag, _, _, kept, _, _ in reversed(_local.state.open):
            if tag == self.tag:
                kept.update(attrs)
                return

    def note_later(self, tensors: dict, finish=None):
        """Add attributes read from the 0-d integer tensors ``tensors`` at the
        next :func:`settle`: their values, or ``finish(values)``, a dict, when
        given (call only while ``recording``)."""
        for tag, _, _, kept, _, _ in reversed(_local.state.open):
            if tag == self.tag:
                _pending.append((kept, tensors, finish))
                return

    def __enter__(self):
        try:
            st = _local.state
        except AttributeError:
            st = _state()
        if not st:
            st.on = _profiler_enabled()
        st.append(self.tag)
        if st.on:
            rf = record_function(self.tag)
            rf.__enter__()
            sid = next(_ids)
            st.open.append((self.tag, sid, st.open[-1][1] if st.open else 0,
                            dict(self.attrs or ()), rf, time.time_ns()))
        return self

    def __exit__(self, typ, value, tb):
        st = _local.state
        if st.on:
            end = time.time_ns()
            tag, sid, parent, attrs, rf, start = st.open.pop()
            rf.__exit__(None, None, None)
            if len(_spans) < MAX_SPANS:
                _spans.append(Span(tag, sid, parent, start, end, attrs))
            else:
                _dropped[0] += 1
        st.pop()
        if _pending and not st:
            settle()


def named_scope(tag: str, **attrs) -> _Scope:
    """A context that pushes ``tag`` for the operations run inside, and is a
    span while profiled.  Without attributes the scope of a tag is made once
    and reused (it keeps no state of its own), so that a scope off the
    profiler costs a push, a pop and two flag reads."""
    if attrs:
        return _Scope(tag, attrs)
    try:
        return _plain[tag]
    except KeyError:
        s = _plain[tag] = _Scope(tag, None)
        return s


def settle():
    """Read the pending notes' device counts into their spans (one read by
    the host); nothing while the current CUDA stream is capturing a graph."""
    if not _pending:
        return
    import torch
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return
    todo = list(_pending)
    _pending.clear()
    flat = [t.reshape(()) for _, tensors, _ in todo for t in tensors.values()]
    values = iter(torch.stack([t.to(flat[0].device) for t in flat]).tolist())
    for attrs, tensors, finish in todo:
        got = {name: next(values) for name in tensors}
        attrs.update(finish(got) if finish is not None else got)


def current_scopes() -> tuple:
    """The tags open in this thread, outermost first."""
    try:
        return tuple(_local.state)
    except AttributeError:
        return ()


def spans() -> list:
    """The recorded spans, in the order they closed (children first)."""
    return list(_spans)


def dropped() -> int:
    """Spans not kept since the last :func:`clear`: the list was full."""
    return _dropped[0]


def clear():
    _spans.clear()
    _dropped[0] = 0


def subtree(spans, tag) -> list:
    """The spans tagged ``tag`` and every span inside one of them."""
    by_id = {s.id: s for s in spans}

    def under(s):
        while s is not None:
            if s.tag == tag:
                return True
            s = by_id.get(s.parent)
        return False
    return [s for s in spans if under(s)]


LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")


def attribute(spans, events) -> dict:
    """Each span tag's share of a profiled stretch: ``{tag: {"count",
    "host_ms", "self_ms", "launches", "idle_ms", "gib"}}``.

    ``spans`` are :class:`Span` s of one thread; ``events`` the profiler's
    (``prof.profiler.kineto_results.events()``).  ``self_ms`` is a span's
    time less its children's; kernel launches (the host's
    ``cudaLaunchKernel*`` / ``cuLaunchKernel*`` calls) and the device's
    idle time (no device operation running) go to the innermost span open
    at that moment, and device idle time outside every span to
    ``"(none)"`` from the first span's start to the last one's end.
    ``gib`` sums a span's attributes whose names end in ``bytes``."""
    rows = defaultdict(lambda: {"count": 0, "host_ms": 0.0, "self_ms": 0.0,
                                "launches": 0, "idle_ms": 0.0, "gib": 0.0})
    kids = defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    # the innermost span at each moment: each span's own stretches, between its children
    own = []
    for s in spans:
        r = rows[s.tag]
        r["count"] += 1
        r["host_ms"] += (s.end_ns - s.start_ns) / 1e6
        r["gib"] += sum(v for k, v in s.attrs.items() if k.endswith("bytes")) / 2**30
        at = s.start_ns
        for c in sorted(kids[s.id], key=lambda c: c.start_ns):
            own.append((at, c.start_ns, s.tag))
            at = c.end_ns
        own.append((at, s.end_ns, s.tag))
    own = [o for o in own if o[1] > o[0]]
    own.sort()
    starts = [a for a, _, _ in own]

    def tag_at(t):
        i = bisect.bisect_right(starts, t) - 1
        return own[i][2] if i >= 0 and t < own[i][1] else None

    for a, b, tag in own:
        rows[tag]["self_ms"] += (b - a) / 1e6
    cuda = DeviceType.CUDA
    busy = []
    for e in events:
        name = e.name()
        if name.startswith(LAUNCHES):
            tag = tag_at(e.start_ns())
            if tag is not None:
                rows[tag]["launches"] += 1
        elif e.device_type() == cuda and not (hasattr(e, "is_user_annotation")
                                              and e.is_user_annotation()):
            busy.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    if not own:
        return dict(rows)
    busy.sort()
    idle, at = [], own[0][0]
    for a, b in busy:
        if a > at:
            idle.append((at, a))
        at = max(at, b)
    idle.append((at, max(at, max(b for _, b, _ in own))))
    j, none = 0, 0
    for a, b in idle:          # each idle stretch cut at the spans' own stretches
        while j < len(own) and own[j][1] <= a:
            j += 1
        k, covered = j, 0
        while k < len(own) and own[k][0] < b:
            lo, hi = max(a, own[k][0]), min(b, own[k][1])
            if hi > lo:
                rows[own[k][2]]["idle_ms"] += (hi - lo) / 1e6
                covered += hi - lo
            k += 1
        none += b - a - covered
    if none:
        rows["(none)"]["idle_ms"] += none / 1e6
    return dict(rows)
