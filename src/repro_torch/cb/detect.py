"""Regression detection over benchmark history (changepoint / CUSUM).

Single-pair analysis compares one commit against its parent; a regression
split across k commits contributes ~1/k of its magnitude per comparison
and hides inside each pairwise CI.  Over the *history*, those per-commit
step estimates are independent measurements whose sum has uncertainty
growing only with sqrt(k): the cumulative change over a window can be
significant even when no individual step is.

For each benchmark the detector scans every commit window, computing

    z(window) = sum(median_i) / sqrt(sum(se_i^2))

where `median_i` is commit i's measured step (exactly 0 with zero variance
when the code fingerprint did not change — unchanged code cannot move
performance, and reusing a cached A/A sample repeatedly would inject its
noise k times) and `se_i` is derived from the stored bootstrap CI.  The
best window's |z| above `z_threshold` raises a `RegressionEvent`; the
event is a *drift* if no single commit in the window was individually
flagged, otherwise a *step*.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.cb.history import HistoryRecord, HistoryStore

# 99% two-sided normal quantile: converts a stored CI half-width to an SE
_Z99 = 2.5758293035489004


@dataclass(frozen=True)
class SeriesPoint:
    commit_index: int
    commit_id: str
    median: float                   # step estimate (0 if code unchanged)
    se: float                       # step standard error (0 if unchanged)
    code_changed: bool
    flagged: bool                   # single-pair detection at this commit


@dataclass(frozen=True)
class RegressionEvent:
    benchmark: str
    start_index: int                # first commit of the flagged window
    end_index: int
    cumulative_pct: float           # summed step medians over the window
    score: float                    # |z| of the window
    kind: str                       # "step" | "drift"
    direction: int                  # +1 regression, -1 improvement

    def __str__(self) -> str:
        span = (f"commit {self.start_index}" if self.start_index ==
                self.end_index else
                f"commits {self.start_index}..{self.end_index}")
        return (f"{self.benchmark}: {self.kind} of "
                f"{self.cumulative_pct:+.1f}% over {span} (z={self.score:.1f})")


@dataclass
class DetectorConfig:
    z_threshold: float = 3.5        # |z| above which a window is an event
    min_cumulative_pct: float = 2.0  # ignore windows below the noise floor
    max_se_floor: float = 1e-6      # windows need at least one measured step
    # robust opt-in: clip each commit's step estimate to +/- this many of
    # its own standard errors before the window scan (0 disables, the
    # bit-identical historical behavior).  One chaos-corrupted commit
    # (billing anomaly, contaminated run) can otherwise carry a whole
    # window past the threshold on its own; Huber-style clipping bounds
    # any single commit's pull at step_clip_z standard errors while
    # leaving genuine multi-commit drifts (many small same-sign steps)
    # untouched.
    step_clip_z: float = 0.0


def record_to_point(r: HistoryRecord) -> SeriesPoint:
    if not r.code_changed or r.median_diff_pct is None or r.ci_low is None:
        # unchanged code (skip / cached A/A / failed run): true step is 0
        return SeriesPoint(r.commit_index, r.commit_id, 0.0, 0.0,
                           r.code_changed, False)
    se = max((r.ci_high - r.ci_low) / 2.0 / _Z99, 1e-9)
    return SeriesPoint(r.commit_index, r.commit_id, r.median_diff_pct, se,
                       True, r.changed)


class RegressionDetector:
    """Changepoint scan over per-benchmark history series."""

    def __init__(self, cfg: Optional[DetectorConfig] = None):
        self.cfg = cfg or DetectorConfig()

    def scan_series(self, benchmark: str,
                    points: List[SeriesPoint]) -> Optional[RegressionEvent]:
        """Best window of the series, if it clears the threshold.

        Vectorized over all O(n^2) windows at once: row i of the shifted
        matrices holds the windows starting at commit i, cumulative sums
        along the row give every window's mass and variance, and the
        winner is the first row-major window attaining the maximum |z| —
        exactly what the former nested-loop scan selected (cumulative sums
        accumulate in the same order, so the floats match bit-for-bit).
        O(n^2) memory over n commits — a 20-commit stream scans in a few
        hundred microseconds; series from long-lived repos should be
        windowed by the caller."""
        cfg = self.cfg
        pts = sorted(points, key=lambda p: p.commit_index)
        m = len(pts)
        if m == 0:
            return None
        med = np.array([p.median for p in pts])
        se = np.array([p.se for p in pts])
        if cfg.step_clip_z > 0.0:
            bound = cfg.step_clip_z * se       # se==0 -> unchanged step 0
            med = np.clip(med, -bound, bound)
        # shifted layout: row i, column t -> commit i+t (0.0 past the end,
        # which leaves the running sums unchanged, like the loop stopping)
        ii = np.arange(m)[:, None] + np.arange(m)[None, :]
        pad = np.concatenate([med, np.zeros(m)])
        s = np.cumsum(pad[ii], axis=1)
        pad[:m] = se ** 2
        var = np.cumsum(pad[ii], axis=1)
        in_range = ii < m
        jj = np.where(in_range, ii, m - 1)
        # windows start at a measured change, end at one, and need more
        # than the variance floor (auto-trimmed windows)
        valid = (in_range & (se[:, None] > 0.0) & (se[jj] > 0.0)
                 & (var > cfg.max_se_floor))
        with np.errstate(divide="ignore", invalid="ignore"):
            absz = np.abs(s) / np.sqrt(var)
        absz[~valid | (absz < cfg.z_threshold)
             | (np.abs(s) < cfg.min_cumulative_pct)] = -np.inf
        flat = np.argmax(absz)          # first row-major occurrence of max
        best_z = absz.ravel()[flat]
        if not np.isfinite(best_z):
            return None
        i, t = divmod(int(flat), m)
        j = i + t
        s_best = float(s[i, t])
        # a window is a *step* if individually-flagged commits already
        # explain most of its mass; otherwise the change only exists in
        # aggregate — a drift.  Uses the (possibly clipped) step values:
        # comparing raw flagged magnitudes against a clipped window sum
        # would let one corrupted flagged commit claim the whole window.
        flagged_mass = sum(float(med[k]) for k in range(i, j + 1)
                           if pts[k].flagged)
        kind = "step" if abs(flagged_mass) >= 0.5 * abs(s_best) else "drift"
        return RegressionEvent(
            benchmark=benchmark,
            start_index=pts[i].commit_index,
            end_index=pts[j].commit_index,
            cumulative_pct=s_best, score=float(best_z), kind=kind,
            direction=1 if s_best > 0 else -1)

    def scan(self, history: HistoryStore, *, provider: Optional[str] = None,
             mode: Optional[str] = None) -> List[RegressionEvent]:
        """Scan every benchmark series; a store holding several providers /
        modes is scanned per (suite, provider, mode) group so unrelated
        measurement series never sum into one window."""
        events: List[RegressionEvent] = []
        for b in history.benchmarks():
            groups: dict = {}
            for r in history.series(b, provider=provider, mode=mode):
                if r.source == "baseline":
                    continue
                groups.setdefault((r.suite, r.provider, r.mode),
                                  []).append(record_to_point(r))
            for pts in groups.values():
                ev = self.scan_series(b, pts)
                if ev is not None:
                    events.append(ev)
        events.sort(key=lambda e: -e.score)
        return events
