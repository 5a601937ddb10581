"""Non-stationary platform performance models (trace models).

The stock provider profiles are *stationary*: a lognormal instance speed
drawn at spawn plus a small diurnal sine.  Real FaaS platforms are not —
SeBS (Copik et al., Middleware '21) and Rese et al. 2024 both document
diurnal drift of several percent, noisy-neighbor interference bursts,
cold-start latency spikes during provider-side scaling events, and
region-to-region heterogeneity.  A `TraceModel` describes one such
time-varying regime as a *pure function of (seed, time, instance)*:

    speed_factor(t, instance_key)  multiplicative slowdown of execution
                                   at virtual time t on that instance
    cold_factor(t)                 multiplicative inflation of cold-start
                                   overhead at virtual time t
    mean_factor()                  long-run mean of speed_factor, used by
                                   the deadline/cost planner to price a
                                   chaos profile without simulating it

Determinism is the load-bearing property: every stochastic trace hashes
``(seed, model tag, instance_key, time epoch)`` into an independent
`numpy` RNG, so the factor at a given (t, instance) never depends on the
order or number of queries — two runs of the same seeded scenario replay
bit-for-bit, and querying one instance's trace cannot perturb another's.

Trace models only *shape* performance; injected faults (lost invocations,
duplicate deliveries, zombie instances, ...) live in chaos.py.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass, replace
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

# model tags keep each trace's RNG stream independent of the others even
# when they share a seed and an instance
_TAG_NEIGHBOR = 101
_TAG_REGION = 103


def instance_key(iid: str) -> int:
    """Stable 32-bit key for an instance id ("i17", "vm3", ...)."""
    return zlib.crc32(iid.encode())


class TraceModel:
    """Stationary base: factor 1 everywhere.  Subclasses override."""

    def speed_factor(self, t: float, inst_key: int = 0) -> float:
        return 1.0

    def cold_factor(self, t: float) -> float:
        return 1.0

    def mean_factor(self) -> float:
        return 1.0

    def scaled(self, intensity: float) -> "TraceModel":
        """The same regime with its amplitude scaled; ``scaled(0)`` must
        be an exact identity (factor 1.0 everywhere)."""
        return self


@dataclass(frozen=True)
class DiurnalTrace(TraceModel):
    """Sinusoidal whole-platform drift: +/- `amplitude` over `period_s`.

    Unlike the profile's built-in diurnal term this one is applied by the
    chaos layer *on top of* the provider model, so sweeps can dial
    non-stationarity without touching provider profiles."""
    amplitude: float = 0.10
    period_s: float = 86400.0
    phase_s: float = 0.0

    def speed_factor(self, t: float, inst_key: int = 0) -> float:
        if self.amplitude == 0.0:
            return 1.0
        return 1.0 + self.amplitude * math.sin(
            2.0 * math.pi * (t + self.phase_s) / self.period_s)

    def scaled(self, intensity: float) -> "DiurnalTrace":
        return replace(self, amplitude=self.amplitude * intensity)


@dataclass(frozen=True)
class ColdSpikeTrace(TraceModel):
    """Cold-start spike windows: every `period_s`, cold-start overheads
    are multiplied by `multiplier` for `window_s` (provider-side scaling
    events / image-cache evictions)."""
    multiplier: float = 4.0
    period_s: float = 3600.0
    window_s: float = 240.0
    phase_s: float = 0.0

    def cold_factor(self, t: float) -> float:
        if self.multiplier == 1.0:
            return 1.0
        return (self.multiplier
                if (t + self.phase_s) % self.period_s < self.window_s
                else 1.0)

    def scaled(self, intensity: float) -> "ColdSpikeTrace":
        return replace(self,
                       multiplier=1.0 + (self.multiplier - 1.0) * intensity)


@dataclass(frozen=True)
class StepTrace(TraceModel):
    """Deterministic step degradation: between `t0_s` and `t1_s` the
    platform (or one region of it, when ``region >= 0`` with
    ``n_regions`` hashing) runs `factor` times slower.  No RNG at all —
    the ground-truth regime for detector evaluation: the injected
    incident window is known exactly, so benchmarks/obs_bench.py can
    score detection latency against it."""
    factor: float = 2.0
    t0_s: float = 0.0
    t1_s: float = 0.0
    region: int = -1
    n_regions: int = 4

    def speed_factor(self, t: float, inst_key: int = 0) -> float:
        if self.factor == 1.0 or not (self.t0_s <= t < self.t1_s):
            return 1.0
        if self.region >= 0 and inst_key % self.n_regions != self.region:
            return 1.0
        return self.factor

    def mean_factor(self) -> float:
        # planner-facing long-run mean; a bounded step window washes out
        # over an unbounded horizon, so price only the in-window share
        # when the caller's horizon is unknown: stay conservative at 1
        return 1.0

    def scaled(self, intensity: float) -> "StepTrace":
        return replace(self, factor=1.0 + (self.factor - 1.0) * intensity)


@lru_cache(maxsize=65536)
def _neighbor_window(seed: int, inst_key: int, epoch: int,
                     burst_prob: float, epoch_s: float, mean_burst_s: float,
                     max_span: int) -> Optional[Tuple[float, float]]:
    """Burst window of one (instance, epoch) — a pure function of its
    arguments, memoized: `active()` consults several epochs per
    invocation, and constructing a fresh Generator per lookup dominated
    the chaos sweep's cost."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed, _TAG_NEIGHBOR, inst_key,
         epoch + NoisyNeighborTrace._EPOCH_OFFSET]))
    u = rng.random()
    if u >= burst_prob:
        return None
    start = epoch * epoch_s + float(rng.random()) * epoch_s
    dur = min(float(rng.exponential(mean_burst_s)), max_span * epoch_s)
    return start, start + dur


@lru_cache(maxsize=4096)
def _region_speed(seed: int, region: int, sigma: float) -> float:
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, _TAG_REGION, region]))
    return float(rng.lognormal(0.0, sigma))


@dataclass(frozen=True)
class RegionTrace(TraceModel):
    """Per-region heterogeneity: instances hash into `n_regions` regions,
    each with a fixed seeded lognormal speed factor (hardware generation /
    zone congestion differences)."""
    n_regions: int = 4
    sigma: float = 0.08
    seed: int = 0

    def speed_factor(self, t: float, inst_key: int = 0) -> float:
        if self.sigma == 0.0:
            return 1.0
        return _region_speed(self.seed, inst_key % self.n_regions,
                             self.sigma)

    def mean_factor(self) -> float:
        # mean of lognormal(0, sigma)
        return math.exp(0.5 * self.sigma * self.sigma)

    def scaled(self, intensity: float) -> "RegionTrace":
        return replace(self, sigma=self.sigma * intensity)


@dataclass(frozen=True)
class NoisyNeighborTrace(TraceModel):
    """Markov-style on/off interference bursts, independently per
    instance.  Time is cut into `epoch_s` epochs; per (instance, epoch)
    a seeded RNG decides whether a burst starts in that epoch
    (probability `burst_prob`), where it starts, and how long it runs
    (exponential with mean `mean_burst_s`, capped at three epochs so a
    lookup only needs to consult a bounded number of past epochs).
    While a burst is active the instance runs `slowdown` times slower.

    The burst schedule is a pure function of (seed, instance, epoch):
    query order cannot perturb it, and two runs replay identically.
    """
    burst_prob: float = 0.25
    epoch_s: float = 600.0
    mean_burst_s: float = 150.0
    slowdown: float = 2.5
    seed: int = 0

    _MAX_EPOCH_SPAN = 3
    # negative epochs are real (a burst may already be running when the
    # virtual clock starts at 0); offset keeps SeedSequence entries
    # non-negative without changing the pure-function property
    _EPOCH_OFFSET = 1_000_003

    def _window(self, inst_key: int,
                epoch: int) -> Optional[Tuple[float, float]]:
        return _neighbor_window(self.seed, inst_key, epoch,
                                self.burst_prob, self.epoch_s,
                                self.mean_burst_s, self._MAX_EPOCH_SPAN)

    def active(self, t: float, inst_key: int) -> bool:
        if self.burst_prob <= 0.0 or self.slowdown == 1.0:
            return False
        epoch = int(t // self.epoch_s)
        for e in range(epoch, epoch - self._MAX_EPOCH_SPAN - 1, -1):
            w = self._window(inst_key, e)
            if w is not None and w[0] <= t < w[1]:
                return True
        return False

    def speed_factor(self, t: float, inst_key: int = 0) -> float:
        return self.slowdown if self.active(t, inst_key) else 1.0

    def duty_cycle(self) -> float:
        """Expected fraction of time a given instance spends in a burst
        (planner-facing; burst overlap makes this a slight over-count)."""
        return min(1.0, self.burst_prob * self.mean_burst_s / self.epoch_s)

    def mean_factor(self) -> float:
        d = self.duty_cycle()
        return 1.0 + d * (self.slowdown - 1.0)

    def scaled(self, intensity: float) -> "NoisyNeighborTrace":
        return replace(self,
                       burst_prob=min(1.0, self.burst_prob * intensity),
                       slowdown=1.0 + (self.slowdown - 1.0)
                       * min(1.0, intensity))
