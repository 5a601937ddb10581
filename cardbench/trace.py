"""The traced run: torch.profiler ranges around the calls into each layer,
put in by the benchmark's own code, and the device time inside each.

Only the run with ``--trace 1`` builds a ``Tracer``; the other runs the
program untouched.  The traced run profiles a stated subset of its batches:
those of the first cycle (every shape of the mix once), each from its
prefill through its first ``DECODE_STEPS`` decode steps.  A range
synchronises the card when it opens and when it closes, so every kernel
launched inside it runs inside it, and a kernel belongs to the ranges that
hold its midpoint on the profiler's clock, whichever way it was launched
(ctypes launches of the port's kernels included).

Ranges: ``prefill`` (``LM.forward`` in prefill), ``decode`` (``LM.decode``),
``grow_cache`` and, inside a prefill, ``attention``
(``models.attention.attention`` called with ``impl="flash"``), ``k1``
(``kernels.ops.flash_attention``, the layout copies around K1 included) and
``ssd`` (``models.ssm.ssd_chunked``, the layout copies around K2 included).
"""
from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field

DECODE_STEPS = 8
PREFIX = "cb."
TOP = 10


@dataclass
class Range:
    name: str
    meta: dict
    start_ns: int = 0
    end_ns: int = 0
    device_s: float = 0.0     # device operations whose midpoint lies inside
    idle_s: float = 0.0       # host seconds with no device operation running

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclass
class TraceData:
    ranges: list = field(default_factory=list)
    busy_s: float = 0.0
    window_s: float = 0.0
    ops: dict = field(default_factory=dict)       # device op name -> seconds
    idle: dict = field(default_factory=dict)      # innermost host range -> idle seconds

    def of(self, name):
        return [r for r in self.ranges if r.name == name]

    def breakdown(self):
        top = sorted(self.ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in gaps]}


class Tracer:
    def __init__(self, torch, on_card=True):
        self.torch = torch
        self.on_card = on_card    # off the card (tests) nothing runs on a device
        self.prof = None
        self.decode_steps = DECODE_STEPS
        self.period_start = 0.0
        self.open = {}            # id -> Range, while profiling
        self.data = TraceData()
        self._undo = []

    # ------------------------------------------------------------ hooks
    def install(self):
        """Wrap the program's layer entry points with ranges.  Outside a
        profiled period a wrapper only calls through."""
        from repro_torch.kernels import ops
        from repro_torch.models import attention, ssm

        def attention_meta(q, k, v, *a, impl="auto", **kw):
            return {"q": tuple(q.shape), "k": tuple(k.shape)} if impl == "flash" else None

        def k1_meta(q, k, v, *a, causal=True, **kw):
            return {"q": tuple(q.shape), "k": tuple(k.shape), "causal": bool(causal),
                    "itemsize": q.element_size()}

        def ssd_meta(x, dt, A, B, C, *a, **kw):
            return {"x": tuple(x.shape), "B": tuple(B.shape), "x_itemsize": x.element_size(),
                    "dt_itemsize": dt.element_size()}

        for mod, name, rng, meta in ((attention, "attention", "attention", attention_meta),
                                     (ops, "flash_attention", "k1", k1_meta),
                                     (ssm, "ssd_chunked", "ssd", ssd_meta)):
            self._wrap(mod, name, rng, meta)

    def _wrap(self, mod, attr, range_name, meta_of):
        fn = getattr(mod, attr)
        tracer = self

        def wrapped(*args, **kwargs):
            meta = meta_of(*args, **kwargs) if tracer.prof is not None else None
            if meta is None:
                return fn(*args, **kwargs)
            with tracer.range(range_name, meta):
                return fn(*args, **kwargs)
        setattr(mod, attr, wrapped)
        self._undo.append((mod, attr, fn))

    def uninstall(self):
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo.clear()

    # ----------------------------------------------------------- periods
    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU]
                            + [ProfilerActivity.CUDA] * self.on_card)
        self.sync()
        self.prof.__enter__()
        self.period_start = time.perf_counter()

    def stop(self):
        if self.prof is None:
            return
        self.sync()
        period_s = time.perf_counter() - self.period_start
        self.data.window_s += period_s
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        self._read(prof.profiler.kineto_results.events(), period_s)

    @contextlib.contextmanager
    def range(self, name, meta=None):
        """A profiler range named ``name`` while a period is profiled (a plain
        call otherwise)."""
        if self.prof is None:
            yield
            return
        r = Range(name, meta or {})
        key = f"{PREFIX}{name}#{len(self.open)}"
        self.open[key] = r
        self.sync()
        with self.torch.profiler.record_function(key):
            yield
            self.sync()

    def sync(self):
        if self.on_card:
            self.torch.cuda.synchronize()

    # ------------------------------------------------------------- reading
    def _read(self, events, period_s):
        cuda = self.torch.autograd.DeviceType.CUDA
        ops, marks = [], []
        for e in events:
            name = e.name()
            annotation = name.startswith(PREFIX) or (hasattr(e, "is_user_annotation")
                                                     and e.is_user_annotation())
            if e.device_type() == cuda:
                if not annotation:
                    ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
            elif name in self.open:
                r = self.open.pop(name)
                r.start_ns, r.end_ns = e.start_ns(), e.start_ns() + e.duration_ns()
                marks.append(r)
        self.open.clear()
        ops.sort()
        mids = [(a + b) / 2 for a, b, _ in ops]
        prefix = [0]
        for a, b, name in ops:
            prefix.append(prefix[-1] + (b - a))
            self.data.ops[name[:120]] = self.data.ops.get(name[:120], 0.0) + (b - a) / 1e9
        for r in marks:
            lo, hi = bisect.bisect_left(mids, r.start_ns), bisect.bisect_right(mids, r.end_ns)
            r.device_s = (prefix[hi] - prefix[lo]) / 1e9
        busy, end = 0, None
        for a, b, _ in ops:
            busy += max(0, b - max(a, end if end is not None else a))
            end = b if end is None else max(end, b)
        for r in marks:
            r.idle_s = max(0.0, r.host_s - r.device_s)
        # idle seconds by what the host was doing: each range's own idle
        # (less its children's), and the rest of the period "outside"
        inside = lambda c, r: r is not c and r.start_ns <= c.start_ns and c.end_ns <= r.end_ns
        top_idle = 0.0
        for r in marks:
            kids = [c for c in marks if inside(c, r)]
            direct = [c for c in kids if not any(inside(c, o) for o in kids)]
            own = max(0.0, r.idle_s - sum(c.idle_s for c in direct))
            self.data.idle[r.name] = self.data.idle.get(r.name, 0.0) + own
            if not any(inside(r, o) for o in marks):
                top_idle += r.idle_s
        self.data.idle["outside"] = self.data.idle.get("outside", 0.0) + max(
            0.0, period_s - busy / 1e9 - top_idle)
        self.data.busy_s += busy / 1e9
        self.data.ranges.extend(marks)
