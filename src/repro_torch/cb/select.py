"""Fingerprint-based benchmark selection.

A benchmark whose code fingerprint is unchanged since its last measurement
cannot have changed performance *because of the commit* — the pipeline may
skip it (Japke et al. 2025).  The environment, however, can drift under
unchanged code, so the selector re-validates stale benchmarks: after
`max_staleness` commits without a measurement a benchmark is scheduled for
an A/A guard run (same fingerprint on both sides).  In cached mode those
revalidations are usually served from the result cache instead of the
platform (cache.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from repro_torch.cb.commits import Commit


@dataclass
class SelectorConfig:
    max_staleness: int = 5      # commits an unchanged benchmark may coast
    select_all: bool = False    # full-suite mode: fingerprints ignored


@dataclass
class Selection:
    """Partition of the suite for one commit."""
    run: List[str]              # fingerprint changed (or never measured)
    revalidate: List[str]       # unchanged but stale: A/A guard run
    skipped: List[str]          # unchanged and fresh: nothing to do

    @property
    def selected(self) -> List[str]:
        return self.run + self.revalidate


class BenchmarkSelector:
    """Tracks per-benchmark fingerprints and measurement staleness across
    a commit stream.  Call `select` once per commit, then `mark_measured`
    for every benchmark that ended up with a result (run or cache hit)."""

    def __init__(self, cfg: SelectorConfig = None):
        self.cfg = cfg or SelectorConfig()
        self._last_fp: Dict[str, str] = {}
        self._last_measured: Dict[str, int] = {}

    def observe_baseline(self, commit: Commit) -> None:
        """Record the stream's first commit: everything counts as measured
        at the baseline (the suite's reference run)."""
        for b, fp in commit.fingerprints.items():
            self._last_fp[b] = fp
            self._last_measured[b] = commit.index

    def select(self, commit: Commit) -> Selection:
        run: List[str] = []
        reval: List[str] = []
        skipped: List[str] = []
        for b in sorted(commit.fingerprints):
            fp = commit.fingerprints[b]
            if self.cfg.select_all or self._last_fp.get(b) != fp:
                run.append(b)
            elif (commit.index - self._last_measured.get(b, commit.index)
                    >= self.cfg.max_staleness):
                reval.append(b)
            else:
                skipped.append(b)
            self._last_fp[b] = fp
        return Selection(run=run, revalidate=reval, skipped=skipped)

    def mark_measured(self, benchmarks: List[str], commit_index: int) -> None:
        for b in benchmarks:
            self._last_measured[b] = commit_index

    def last_measured(self, benchmark: str):
        """Current staleness-clock entry (None if never marked)."""
        return self._last_measured.get(benchmark)

    def unmark_measured(self, benchmark: str, previous,
                        commit_index: int) -> None:
        """Roll back an optimistic `mark_measured` that never produced a
        result (a preempted service job): restore the pre-mark value so
        the staleness clock does not credit a measurement that never
        happened.  No-op if a later commit has re-marked the benchmark."""
        if self._last_measured.get(benchmark) != commit_index:
            return
        if previous is None:
            self._last_measured.pop(benchmark, None)
        else:
            self._last_measured[benchmark] = previous
