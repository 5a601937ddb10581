"""Commit-stream model for continuous benchmarking.

A `Commit` is one code version of a benchmark suite: per-benchmark code
**fingerprints** (content digests of the code each benchmark exercises)
plus, for synthetic streams, the ground truth of what the commit did to
performance.  Fingerprints are the selection key (select.py): a benchmark
whose fingerprint equals its parent's cannot have changed performance, so
the pipeline may skip or cache it (Japke et al. 2025's key lever for
making FaaS benchmarking CI-viable).

`synthetic_stream` generates a deterministic stream over the synthetic
suite: most commits touch a handful of benchmarks, most touched benchmarks
are perf-neutral refactors (fingerprint changes, effect 0 — the selector
must still run them), some carry paper-shaped step effects, and one
benchmark receives a **multi-commit drift**: a per-commit regression small
enough to hide inside a single pairwise CI but large enough in aggregate
that only history-level changepoint analysis (detect.py) can flag it.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def code_digest(*parts) -> str:
    """Stable short content digest used as a benchmark code fingerprint."""
    h = hashlib.sha256()
    for p in parts:
        h.update(str(p).encode())
        h.update(b"\x00")
    return h.hexdigest()[:16]


@dataclass(frozen=True)
class Commit:
    """One code version in a stream, with per-benchmark ground truth.

    `step_effects[b]` is the true v(parent)->v(this) performance change of
    benchmark b in percent (positive = slower); benchmarks absent from the
    dict are unchanged.  `levels[b]` is the cumulative slowdown multiplier
    of b at this commit relative to the stream's first commit — pairwise
    runs only need the step, but costs scale with the level."""
    commit_id: str
    index: int
    parent: Optional[str]
    timestamp_s: float
    fingerprints: Dict[str, str]
    step_effects: Dict[str, float] = field(default_factory=dict)
    levels: Dict[str, float] = field(default_factory=dict)
    touched: Tuple[str, ...] = ()

    def fingerprint(self, benchmark: str) -> str:
        return self.fingerprints[benchmark]

    def step_effect(self, benchmark: str) -> float:
        return self.step_effects.get(benchmark, 0.0)

    def level(self, benchmark: str) -> float:
        return self.levels.get(benchmark, 1.0)

    def parent_level(self, benchmark: str) -> float:
        return self.level(benchmark) / (1.0 + self.step_effect(benchmark)
                                        / 100.0)


@dataclass(frozen=True)
class DriftSpec:
    """A slow regression split across consecutive commits."""
    benchmark: str
    start: int                      # index of the first drifting commit
    length: int                     # number of consecutive drifting commits
    per_commit_pct: float

    @property
    def end(self) -> int:
        return self.start + self.length - 1

    @property
    def total_pct(self) -> float:
        """Cumulative slowdown over the whole window (compounded)."""
        return ((1.0 + self.per_commit_pct / 100.0) ** self.length - 1.0) \
            * 100.0

    def commits(self) -> range:
        return range(self.start, self.start + self.length)


@dataclass
class StreamConfig:
    """Shape of a synthetic commit stream (defaults give the paper-table
    20-commit stream)."""
    n_commits: int = 20
    touched_lo: int = 4             # benchmarks touched per commit
    touched_hi: int = 14
    p_effect: float = 0.35          # touched benchmark carries a real change
    commit_interval_s: float = 21600.0   # one commit every 6 virtual hours
    drift_per_commit_pct: float = 1.0    # below one pairwise CI half-width
    drift_length: int = 12
    drift_start: Optional[int] = None    # default: centered in the stream
    seed: int = 0


def _step_effect(rng: np.random.Generator) -> float:
    """Paper-shaped single-commit effect: mostly 3-20% either way, a tail
    of large regressions (§6.2.2 magnitudes)."""
    sign = float(rng.choice([-1.0, 1.0]))
    if rng.random() < 0.12:
        return sign * float(rng.uniform(30.0, 80.0))
    return sign * float(np.exp(rng.uniform(np.log(3.0), np.log(20.0))))


def synthetic_stream(benchmarks: Sequence[str], cfg: StreamConfig, *,
                     effectable: Optional[Sequence[str]] = None,
                     drift_candidates: Optional[Sequence[str]] = None
                     ) -> Tuple[List[Commit], DriftSpec]:
    """Deterministic commit stream over `benchmarks`.

    `effectable` restricts which benchmarks may receive true effects
    (e.g. exclude ones that cannot execute on the platform, so ground-truth
    accuracy is computed over measurable benchmarks only); touched-but-
    neutral refactors may hit any benchmark.  `drift_candidates` restricts
    the drifting benchmark (pick quiet, always-executable ones so the
    drift is hidden by per-commit CIs rather than by failures)."""
    names = sorted(benchmarks)
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0xC0FFEE]))
    effectable_set = set(effectable if effectable is not None else names)
    cands = sorted(drift_candidates if drift_candidates is not None
                   else effectable_set)
    if not cands:
        raise ValueError("no drift candidate benchmarks")
    drift_bench = cands[int(rng.integers(len(cands)))]
    length = min(cfg.drift_length, cfg.n_commits - 1)
    start = cfg.drift_start
    if start is None:
        start = max(1, (cfg.n_commits - length) // 2 + 1)
    length = min(length, cfg.n_commits - start)
    if length < 1:
        raise ValueError("drift window exceeds the stream length")
    drift = DriftSpec(benchmark=drift_bench, start=start, length=length,
                      per_commit_pct=cfg.drift_per_commit_pct)

    # stream-scoped commit ids: two streams with different seeds never
    # alias each other's records inside an accumulated history store
    cid = f"s{cfg.seed}-c{{:04d}}".format
    fps = {b: code_digest(cfg.seed, b, "v0") for b in names}
    levels = {b: 1.0 for b in names}
    commits = [Commit(commit_id=cid(0), index=0, parent=None,
                      timestamp_s=0.0, fingerprints=dict(fps),
                      levels=dict(levels))]
    for k in range(1, cfg.n_commits):
        n_touch = int(rng.integers(cfg.touched_lo, cfg.touched_hi + 1))
        touched = set(rng.choice(names, size=n_touch, replace=False).tolist())
        # the drift is an ordinary code change from the stream's viewpoint:
        # its fingerprint moves every drifting commit, so selection always
        # re-measures it — it hides inside the per-commit CI, not the cache
        if k in drift.commits():
            touched.add(drift_bench)
        elif drift_bench in touched:
            touched.discard(drift_bench)    # keep its ground truth clean
        steps: Dict[str, float] = {}
        for b in sorted(touched):
            if b == drift_bench and k in drift.commits():
                steps[b] = cfg.drift_per_commit_pct
            elif b in effectable_set and rng.random() < cfg.p_effect:
                steps[b] = _step_effect(rng)
            fps[b] = code_digest(cfg.seed, b, f"v{k}")
        for b, e in steps.items():
            levels[b] *= 1.0 + e / 100.0
        commits.append(Commit(
            commit_id=cid(k), index=k, parent=commits[-1].commit_id,
            timestamp_s=k * cfg.commit_interval_s, fingerprints=dict(fps),
            step_effects=steps, levels=dict(levels),
            touched=tuple(sorted(touched))))
    return commits, drift
