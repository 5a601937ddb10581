"""Streaming anomaly detectors over windowed metric series.

Each detector is a small deterministic state machine fed *closed*
virtual-time windows in order (a window closes once the clock has moved
past its end).  State is a pure function of ``(series, config)``: no
wall clock, no RNG, no dependence on how the series was chunked into
windows-per-drain — the property tests in tests/test_obs_monitoring.py
pin both invariants.

Detectors consume the ``(count, sum, min, max)`` aggregates kept by
``metrics.WindowedRing`` and emit fire/clear events::

    {"detector": "ewma_z", "state": "fire", "window": 12, "t": 720.0,
     "value": 4.1, "baseline": 0.9, "score": 5.2}

``DetectorBank`` binds one ring to a list of detectors and tracks the
feed frontier, synthesizing empty windows for gaps so rate detectors
see silence (a burst ending is as much signal as it starting).

The ``StaticThreshold`` detector is deliberately naive — a fixed
absolute trigger with no baseline — and exists as the comparison
baseline for benchmarks/obs_bench.py's ``slo_detection`` table.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.obs.metrics import WindowedRing

Agg = Optional[Tuple[int, float, float, float]]   # (count, sum, min, max)


def _extract(value: str, window_s: float, agg: Agg) -> Optional[float]:
    """Pull the watched scalar out of a window aggregate.  ``count`` and
    ``rate`` treat an empty window as 0; the value-shaped extractions
    (mean/sum/min/max) have nothing to say about an empty window."""
    if value == "count":
        return 0.0 if agg is None else float(agg[0])
    if value == "rate":
        return 0.0 if agg is None else agg[0] / window_s
    if agg is None or agg[0] == 0:
        return None
    if value == "mean":
        return agg[1] / agg[0]
    if value == "sum":
        return agg[1]
    if value == "min":
        return agg[2]
    if value == "max":
        return agg[3]
    raise ValueError(f"unknown watched value {value!r}")


class Detector:
    """Base: subclasses implement ``update``; ``name`` tags events."""

    name = "detector"

    def __init__(self, value: str = "mean"):
        self.value = value
        self.alerting = False

    def update(self, w: int, window_s: float, agg: Agg) -> Optional[dict]:
        raise NotImplementedError

    def _event(self, state: str, w: int, window_s: float, x: float,
               baseline: float, score: float) -> dict:
        self.alerting = state == "fire"
        return {"detector": self.name, "value_kind": self.value,
                "state": state, "window": int(w), "t": w * window_s,
                "t_end": (w + 1) * window_s, "value": x,
                "baseline": baseline, "score": score,
                "message": (f"{self.name} {state}: {self.value} {x:.4g} "
                            f"vs baseline {baseline:.4g} "
                            f"(score {score:.3g}) in "
                            f"[{w * window_s:.0f}s,"
                            f"{(w + 1) * window_s:.0f}s)")}


class EWMAZScore(Detector):
    """EWMA mean/variance baseline with z-score hysteresis.

    Fires when ``|z| >= z_on`` and clears only once ``|z| <= z_off``
    (z_off < z_on), so a value oscillating around the trigger does not
    flap.  The baseline is frozen while alerting — an incident must not
    teach the detector that broken is normal.

    Release path: while alerting, a *recovery shadow* (an EWMA resumed
    from the frozen state) keeps tracking the signal.  When the signal
    sits within ``z_off`` shadow-sigmas for ``settle_windows``
    consecutive windows — it has settled, whether back at the old
    normal or at a *new* steady level — hysteresis releases: the clear
    is emitted and the shadow is adopted as the baseline.  Resuming
    from the frozen values directly would re-fire immediately on the
    stale z-score whenever the settled level differs from the
    pre-incident one, flapping an endless episode per
    ``settle_windows``; adoption makes a settled step exactly one
    fire/clear episode.
    """

    name = "ewma_z"

    def __init__(self, value: str = "mean", alpha: float = 0.3,
                 z_on: float = 4.0, z_off: float = 1.5,
                 warmup: int = 5, min_sigma: float = 1e-9,
                 settle_windows: int = 8):
        super().__init__(value)
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if z_off >= z_on:
            raise ValueError(f"need z_off < z_on, got {z_off} >= {z_on}")
        if settle_windows < 1:
            raise ValueError(
                f"settle_windows must be >= 1, got {settle_windows}")
        self.alpha = alpha
        self.z_on = z_on
        self.z_off = z_off
        self.warmup = warmup
        self.min_sigma = min_sigma
        self.settle_windows = settle_windows
        self._mean = 0.0
        self._m2 = 0.0        # Welford sum of squared deviations (warmup)
        self._var = 0.0       # EWMA variance (after warmup)
        self._seen = 0
        self._sh_mean = 0.0   # recovery shadow (tracks while alerting)
        self._sh_var = 0.0
        self._settled = 0

    def update(self, w: int, window_s: float, agg: Agg) -> Optional[dict]:
        x = _extract(self.value, window_s, agg)
        if x is None:
            return None
        if self._seen < self.warmup:
            # Welford warmup: establish the baseline before judging
            self._seen += 1
            d = x - self._mean
            self._mean += d / self._seen
            self._m2 += d * (x - self._mean)
            if self._seen == self.warmup:
                self._var = self._m2 / max(1, self._seen - 1)
            return None
        sigma = max(self.min_sigma, math.sqrt(self._var))
        z = (x - self._mean) / sigma
        ev = None
        if not self.alerting and abs(z) >= self.z_on:
            ev = self._event("fire", w, window_s, x, self._mean, z)
            # seed the recovery shadow from the frozen state: it keeps
            # updating while the judged baseline stays frozen
            self._sh_mean, self._sh_var = self._mean, self._var
            self._settled = 0
        elif self.alerting and abs(z) <= self.z_off:
            # ordinary release: the signal came back to the old normal
            ev = self._event("clear", w, window_s, x, self._mean, z)
        elif self.alerting:
            ssig = max(self.min_sigma, math.sqrt(self._sh_var))
            sz = (x - self._sh_mean) / ssig
            self._settled = self._settled + 1 if abs(sz) <= self.z_off \
                else 0
            if self._settled >= self.settle_windows:
                # settled at a new steady level: release and adopt the
                # shadow, so updates resume from the frozen state's
                # continuation instead of re-judging against the stale
                # pre-incident mean (which would re-fire immediately)
                ev = self._event("clear", w, window_s, x, self._sh_mean,
                                 sz)
                self._mean, self._var = self._sh_mean, self._sh_var
            else:
                d = x - self._sh_mean
                self._sh_mean += self.alpha * d
                self._sh_var = ((1 - self.alpha) * self._sh_var
                                + self.alpha * d * d)
        if not self.alerting:
            # EWMA tracking; frozen while alerting so the incident does
            # not teach the detector that broken is normal
            d = x - self._mean
            self._mean += self.alpha * d
            self._var = (1 - self.alpha) * self._var + self.alpha * d * d
        return ev


class RateSpike(Detector):
    """Per-window event-count spike vs a rolling mean baseline.

    Fires when the window count is both ``>= ratio x baseline`` and
    ``>= min_count`` (the floor keeps a 0→2 blip from counting as a
    spike); clears when the count drops back under ``clear_ratio x
    baseline``.  Baseline is the mean of the last ``baseline_windows``
    non-alerting windows.
    """

    name = "rate_spike"

    def __init__(self, value: str = "count", ratio: float = 3.0,
                 clear_ratio: float = 1.5, min_count: int = 5,
                 baseline_windows: int = 8, warmup: int = 3):
        super().__init__(value)
        if clear_ratio >= ratio:
            raise ValueError(
                f"need clear_ratio < ratio, got {clear_ratio} >= {ratio}")
        self.ratio = ratio
        self.clear_ratio = clear_ratio
        self.min_count = min_count
        self.baseline_windows = baseline_windows
        self.warmup = warmup
        self._recent: List[float] = []

    def _baseline(self) -> float:
        if not self._recent:
            return 0.0
        return sum(self._recent) / len(self._recent)

    def update(self, w: int, window_s: float, agg: Agg) -> Optional[dict]:
        x = _extract(self.value, window_s, agg)
        if x is None:
            return None
        base = self._baseline()
        ev = None
        if len(self._recent) >= self.warmup:
            hot = x >= max(self.min_count, self.ratio * base)
            if not self.alerting and hot:
                # zero baseline: report the raw count as the score (a
                # finite value keeps the health JSON strictly valid)
                score = x / base if base > 0 else x
                ev = self._event("fire", w, window_s, x, base, score)
            elif self.alerting and x <= self.clear_ratio * base:
                score = x / base if base > 0 else 0.0
                ev = self._event("clear", w, window_s, x, base, score)
        if not self.alerting:
            self._recent.append(x)
            if len(self._recent) > self.baseline_windows:
                self._recent.pop(0)
        return ev


class StuckGauge(Detector):
    """A value frozen for N windows while traffic keeps flowing.

    Catches dead sensors and wedged pipelines: the watched value (mean
    by default) stays within ``tolerance`` of its first observation for
    ``stuck_windows`` consecutive non-empty windows.  Empty windows
    reset nothing — silence is not stuckness, it is absence.
    """

    name = "stuck_gauge"

    def __init__(self, value: str = "mean", stuck_windows: int = 6,
                 tolerance: float = 0.0, min_count: int = 1):
        super().__init__(value)
        self.stuck_windows = stuck_windows
        self.tolerance = tolerance
        self.min_count = min_count
        self._ref: Optional[float] = None
        self._run = 0

    def update(self, w: int, window_s: float, agg: Agg) -> Optional[dict]:
        x = _extract(self.value, window_s, agg)
        if x is None or (agg is not None and agg[0] < self.min_count):
            return None
        stuck = (self._ref is not None
                 and abs(x - self._ref) <= self.tolerance)
        if stuck:
            self._run += 1
        else:
            self._ref = x
            self._run = 1
        if not self.alerting and self._run >= self.stuck_windows:
            return self._event("fire", w, window_s, x, self._ref,
                               float(self._run))
        if self.alerting and not stuck:
            return self._event("clear", w, window_s, x, x, 0.0)
        return None


class StaticThreshold(Detector):
    """Naive fixed-threshold trigger — the obs_bench comparison
    baseline.  No adaptive baseline, no hysteresis beyond the threshold
    itself: fires whenever the value crosses ``threshold``, clears when
    it drops back under."""

    name = "static_threshold"

    def __init__(self, value: str = "count", threshold: float = 10.0):
        super().__init__(value)
        self.threshold = threshold

    def update(self, w: int, window_s: float, agg: Agg) -> Optional[dict]:
        x = _extract(self.value, window_s, agg)
        if x is None:
            return None
        if not self.alerting and x >= self.threshold:
            return self._event("fire", w, window_s, x, self.threshold,
                               x / self.threshold if self.threshold else x)
        if self.alerting and x < self.threshold:
            return self._event("clear", w, window_s, x, self.threshold,
                               x / self.threshold if self.threshold else
                               0.0)
        return None


class DetectorBank:
    """Binds one windowed ring to a detector list and feeds closed
    windows in order.

    ``drain(now)`` pushes every window that closed strictly before
    ``now`` and was not yet fed, synthesizing empty windows for gaps
    (bounded by the ring capacity so a long idle stretch cannot stall
    the drain).  Because windows are only fed once closed and always in
    index order, drain cadence does not change detector state — the
    chunking-invariance property test pins this.
    """

    def __init__(self, series: str, ring: WindowedRing,
                 detectors: List[Detector], labels: Optional[dict] = None):
        self.series = series
        self.ring = ring
        self.detectors = list(detectors)
        self.labels = dict(labels or {})
        self._frontier: Optional[int] = None

    def drain(self, now: float) -> List[dict]:
        """Feed windows closed before virtual time ``now``; return the
        fire/clear events they produced, tagged with series + labels."""
        closed = int(math.floor(now / self.ring.window_s))   # exclusive
        indices = self.ring.window_indices()
        if self._frontier is None:
            if not indices:
                return []
            self._frontier = indices[0]
        start = self._frontier
        if closed <= start:
            return []
        # cap gap synthesis at ring capacity: older windows are evicted
        # anyway, and detectors should not spin through eons of silence
        if closed - start > self.ring.capacity:
            start = closed - self.ring.capacity
        events: List[dict] = []
        for w in range(start, closed):
            agg = self.ring.aggregate(w)
            for det in self.detectors:
                ev = det.update(w, self.ring.window_s, agg)
                if ev is not None:
                    ev["series"] = self.series
                    ev["message"] = f"{self.series}: {ev['message']}"
                    if self.labels:
                        ev["labels"] = dict(self.labels)
                    events.append(ev)
        self._frontier = closed
        return events


__all__ = ["Agg", "Detector", "DetectorBank", "EWMAZScore", "RateSpike",
           "StaticThreshold", "StuckGauge"]
