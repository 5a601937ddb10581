"""Metrics: counters, gauges, and fixed-bucket quantile sketches.

Every series is keyed by ``(name, labels)`` where labels is a sorted
tuple of ``(key, value)`` pairs — the conventional label set across the
stack is ``(tenant, provider, benchmark)``, each optional.  Histograms
use a deterministic fixed log-bucket sketch (not P², whose estimates
depend on arrival order in ways that are hard to pin in tests): with
128 buckets growing 25% per step from 1 µs, any virtual-time latency up
to ~10^6 s lands in a bucket and quantiles are exact to one bucket
width (~12% relative), while min/max/sum/count stay exact.

The registry is plain accumulation — no RNG, no reordering — so it
shares the tracer's zero-perturbation contract.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Tuple

_LO = 1e-6
_GROWTH = 1.25
_NBUCKETS = 128
_LOG_GROWTH = math.log(_GROWTH)


class QuantileSketch:
    """Fixed log-bucket histogram: deterministic, mergeable, O(1) insert."""

    __slots__ = ("buckets", "count", "total", "vmin", "vmax")

    def __init__(self):
        self.buckets = [0] * _NBUCKETS
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v <= _LO:
            idx = 0
        else:
            idx = min(_NBUCKETS - 1,
                      1 + int(math.log(v / _LO) / _LOG_GROWTH))
        self.buckets[idx] += 1

    def observe_array(self, values) -> None:
        """Bulk insert (vectorized-engine wave flush): same buckets as
        ``observe`` but one numpy pass instead of a Python loop."""
        import numpy as np
        v = np.asarray(values, float).ravel()
        if not v.size:
            return
        self.count += int(v.size)
        # cumulative sum seeded by the running total replays the exact
        # sequential float accumulation (np.sum's pairwise reduction
        # would drift in the last ulp)
        acc = np.empty(v.size + 1)
        acc[0] = self.total
        acc[1:] = v
        self.total = float(np.cumsum(acc)[-1])
        self.vmin = min(self.vmin, float(v.min()))
        self.vmax = max(self.vmax, float(v.max()))
        big = np.maximum(v, _LO)
        idx = np.where(
            v <= _LO, 0,
            np.minimum(_NBUCKETS - 1,
                       1 + (np.log(big / _LO) / _LOG_GROWTH).astype(
                           np.int64)))
        for i, n in zip(*np.unique(idx, return_counts=True)):
            self.buckets[int(i)] += int(n)

    def merge(self, other: "QuantileSketch") -> None:
        """Fold ``other`` into this sketch.  Buckets are aligned by
        construction (same _LO/_GROWTH), so the merge is exact for
        count/min/max/buckets and quantiles stay bucket-resolution."""
        if not other.count:
            return
        self.count += other.count
        self.total += other.total
        if other.vmin < self.vmin:
            self.vmin = other.vmin
        if other.vmax > self.vmax:
            self.vmax = other.vmax
        for i, n in enumerate(other.buckets):
            if n:
                self.buckets[i] += n

    @classmethod
    def from_row(cls, row: dict) -> Optional["QuantileSketch"]:
        """Rebuild a sketch from a snapshot histogram row.  Needs the
        sparse ``buckets`` field (present since snapshot rows started
        carrying it); returns None for rows without it so callers can
        fall back to summary-only aggregation."""
        if "buckets" not in row:
            return None
        sk = cls()
        sk.count = int(row["count"])
        sk.total = float(row["sum"])
        if sk.count:
            sk.vmin = float(row["min"])
            sk.vmax = float(row["max"])
        for i, n in row["buckets"]:
            sk.buckets[int(i)] = int(n)
        return sk

    def sparse_buckets(self) -> List[List[int]]:
        return [[i, n] for i, n in enumerate(self.buckets) if n]

    def quantile(self, q: float) -> float:
        """Value at quantile q in [0, 1], to one bucket's resolution."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for idx, n in enumerate(self.buckets):
            seen += n
            if seen >= rank:
                if idx == 0:
                    return min(self.vmax, _LO)
                lo = _LO * _GROWTH ** (idx - 1)
                hi = lo * _GROWTH
                mid = math.sqrt(lo * hi)
                return min(self.vmax, max(self.vmin, mid))
        return self.vmax

    def summary(self) -> dict:
        if not self.count:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {"count": self.count, "sum": self.total,
                "min": self.vmin, "max": self.vmax,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class WindowedRing:
    """Per-window aggregates of one virtual-time value series.

    Divides the virtual clock into fixed ``window_s`` windows and keeps
    ``(count, sum, min, max)`` per window — the raw material for the
    streaming detectors and burn-rate SLO evaluators.  Aggregation only:
    no RNG, no reordering, bounded memory (oldest windows are evicted
    past ``capacity``), so it lives under the same zero-perturbation
    contract as the rest of the registry.

    ``observe_many`` is bit-for-bit equal to calling ``observe`` once
    per ``(t, value)`` pair in order: the batch is split at window
    change-points (preserving arrival order even when timestamps
    interleave) and each segment replays the window's sequential float
    accumulation with a seeded cumulative sum.
    """

    __slots__ = ("window_s", "capacity", "_agg")

    def __init__(self, window_s: float, capacity: int = 4096):
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        self.window_s = float(window_s)
        self.capacity = int(capacity)
        # window index -> [count, sum, min, max]
        self._agg: Dict[int, List[float]] = {}

    def _bucket(self, w: int) -> List[float]:
        agg = self._agg.get(w)
        if agg is None:
            agg = self._agg[w] = [0, 0.0, math.inf, -math.inf]
            if len(self._agg) > self.capacity:
                del self._agg[min(self._agg)]
        return agg

    def observe(self, t: float, value: float) -> None:
        v = float(value)
        agg = self._bucket(int(float(t) // self.window_s))
        agg[0] += 1
        agg[1] += v
        if v < agg[2]:
            agg[2] = v
        if v > agg[3]:
            agg[3] = v

    def observe_many(self, ts, values) -> None:
        """Bulk insert (vectorized-engine wave flush); see class note."""
        import numpy as np
        t = np.asarray(ts, float).ravel()
        v = np.asarray(values, float).ravel()
        if not t.size:
            return
        if t.size != v.size:
            raise ValueError("ts and values must have equal length")
        w = (t // self.window_s).astype(np.int64)
        # split at window change-points: each contiguous segment hits one
        # window, and segments are applied in arrival order, so repeated
        # visits to a window accumulate exactly as the scalar loop would
        cuts = np.flatnonzero(w[1:] != w[:-1]) + 1
        starts = np.concatenate(([0], cuts))
        ends = np.concatenate((cuts, [t.size]))
        for s, e in zip(starts, ends):
            seg = v[s:e]
            agg = self._bucket(int(w[s]))
            agg[0] += int(e - s)
            acc = np.empty(seg.size + 1)
            acc[0] = agg[1]
            acc[1:] = seg
            agg[1] = float(np.cumsum(acc)[-1])
            mn = float(seg.min())
            mx = float(seg.max())
            if mn < agg[2]:
                agg[2] = mn
            if mx > agg[3]:
                agg[3] = mx

    # ------------------------------------------------------------- reads
    def __len__(self) -> int:
        return len(self._agg)

    def window_indices(self) -> List[int]:
        return sorted(self._agg)

    def aggregate(self, w: int) -> Optional[Tuple[int, float, float, float]]:
        agg = self._agg.get(w)
        if agg is None:
            return None
        return (int(agg[0]), agg[1], agg[2], agg[3])

    def series(self) -> List[Tuple[int, int, float, float, float]]:
        """Sorted ``(window_index, count, sum, min, max)`` rows."""
        return [(w, int(a[0]), a[1], a[2], a[3])
                for w, a in sorted(self._agg.items())]

    def snapshot_rows(self) -> List[List[float]]:
        return [[w, int(a[0]), a[1], a[2], a[3]]
                for w, a in sorted(self._agg.items())]


_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: dict) -> _Key:
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


class MetricsRegistry:
    """Counters / gauges / histograms keyed by (name, sorted labels)."""

    def __init__(self):
        self._counters: Dict[_Key, float] = {}
        self._gauges: Dict[_Key, float] = {}
        self._hists: Dict[_Key, QuantileSketch] = {}
        self._windows: Dict[_Key, WindowedRing] = {}

    # ------------------------------------------------------------ writes
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        k = _key(name, labels)
        self._counters[k] = self._counters.get(k, 0.0) + value

    def inc_seq(self, name: str, values, **labels) -> None:
        """Bulk counter add (vectorized-engine wave flush), bit-for-bit
        equal to calling ``inc`` once per value in order: the running
        float accumulation is replayed with a cumulative sum seeded by
        the counter's current value."""
        import numpy as np
        v = np.asarray(values, float).ravel()
        if not v.size:
            return
        k = _key(name, labels)
        arr = np.empty(v.size + 1)
        arr[0] = self._counters.get(k, 0.0)
        arr[1:] = v
        self._counters[k] = float(np.cumsum(arr)[-1])

    def set_gauge(self, name: str, value: float, **labels) -> None:
        self._gauges[_key(name, labels)] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        k = _key(name, labels)
        sk = self._hists.get(k)
        if sk is None:
            sk = self._hists[k] = QuantileSketch()
        sk.observe(value)

    def observe_many(self, name: str, values, **labels) -> None:
        k = _key(name, labels)
        sk = self._hists.get(k)
        if sk is None:
            sk = self._hists[k] = QuantileSketch()
        sk.observe_array(values)

    def window(self, name: str, window_s: float = 60.0,
               capacity: int = 4096, **labels) -> WindowedRing:
        """Get-or-create the windowed ring for ``(name, labels)``.  The
        first caller fixes ``window_s``; later callers must agree."""
        k = _key(name, labels)
        ring = self._windows.get(k)
        if ring is None:
            ring = self._windows[k] = WindowedRing(window_s, capacity)
        elif ring.window_s != float(window_s):
            raise ValueError(
                f"window {k} already registered with "
                f"window_s={ring.window_s}, asked for {window_s}")
        return ring

    # ------------------------------------------------------------- reads
    def counter_total(self, name: str, **match) -> float:
        """Sum of every counter series with this name whose labels are a
        superset of ``match`` (empty match sums all series)."""
        want = sorted((k, str(v)) for k, v in match.items())
        tot = 0.0
        for (n, labels), v in self._counters.items():
            if n == name and all(kv in labels for kv in want):
                tot += v
        return tot

    def counter_series(self, name: str) -> List[Tuple[dict, float]]:
        return [(dict(labels), v)
                for (n, labels), v in sorted(self._counters.items())
                if n == name]

    def gauge(self, name: str, **labels) -> Optional[float]:
        return self._gauges.get(_key(name, labels))

    def histogram(self, name: str, **labels) -> Optional[QuantileSketch]:
        return self._hists.get(_key(name, labels))

    def histogram_series(self, name: str) -> List[Tuple[dict,
                                                        QuantileSketch]]:
        return [(dict(labels), sk)
                for (n, labels), sk in sorted(self._hists.items())
                if n == name]

    def window_series(self, name: str) -> List[Tuple[dict, WindowedRing]]:
        return [(dict(labels), ring)
                for (n, labels), ring in sorted(self._windows.items())
                if n == name]

    def label_values(self, label: str) -> List[str]:
        """Every value this label takes across all series (sorted)."""
        vals = set()
        for store in (self._counters, self._gauges, self._hists,
                      self._windows):
            for _, labels in store.keys():
                for k, v in labels:
                    if k == label:
                        vals.add(v)
        return sorted(vals)

    # ------------------------------------------------------------ export
    def snapshot(self) -> dict:
        def rows(store, render):
            return [{"name": n, "labels": dict(labels),
                     "value": render(v)}
                    for (n, labels), v in sorted(store.items())]
        return {"schema": 1,
                "counters": rows(self._counters, float),
                "gauges": rows(self._gauges, float),
                "histograms": [{"name": n, "labels": dict(labels),
                                **sk.summary(),
                                "buckets": sk.sparse_buckets()}
                               for (n, labels), sk
                               in sorted(self._hists.items())],
                "windows": [{"name": n, "labels": dict(labels),
                             "window_s": ring.window_s,
                             "rows": ring.snapshot_rows()}
                            for (n, labels), ring
                            in sorted(self._windows.items())]}

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
