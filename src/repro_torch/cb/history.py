"""Persistent regression history: one record per (commit, benchmark).

The history store is the pipeline's long-term memory — per-commit
per-benchmark confidence intervals, invocation counts, and attributed
costs, across providers and runs.  The regression detector (detect.py)
reads per-benchmark series out of it; CI uploads it as a build artifact so
the next pipeline run starts from the accumulated history.

Records are schema-versioned JSONL (append-only, torn-tail tolerant,
mergeable across shards, like core/results.py), with an optional SQLite
export for ad-hoc queries.
"""
from __future__ import annotations

import json
import os
import sqlite3
from dataclasses import asdict, dataclass, fields
from typing import Dict, List, Optional

from repro_torch.core.results import load_jsonl
from repro_torch.core.stats import ChangeResult

SCHEMA_VERSION = 1

SOURCE_RUN = "run"          # measured on the platform this commit
SOURCE_CACHE = "cache"      # served from the result cache
SOURCE_SKIP = "skip"        # fingerprint unchanged: no measurement needed
SOURCE_BASELINE = "baseline"


@dataclass
class HistoryRecord:
    schema: int
    suite: str
    provider: str
    mode: str
    commit_id: str
    commit_index: int
    benchmark: str
    fingerprint: str
    code_changed: bool              # fingerprint differs from parent's
    source: str                     # run | cache | skip | baseline
    n_pairs: int = 0
    median_diff_pct: Optional[float] = None
    ci_low: Optional[float] = None
    ci_high: Optional[float] = None
    changed: bool = False
    direction: int = 0
    invocations: int = 0
    billed_seconds: float = 0.0
    cost_dollars: float = 0.0

    @classmethod
    def from_change(cls, change: Optional[ChangeResult],
                    **kw) -> "HistoryRecord":
        if change is not None:
            kw.update(n_pairs=change.n_pairs,
                      median_diff_pct=change.median_diff_pct,
                      ci_low=change.ci_low, ci_high=change.ci_high,
                      changed=change.changed, direction=change.direction)
        return cls(schema=SCHEMA_VERSION, **kw)


class HistoryStore:
    """Append-only history with per-benchmark series access.

    `path=None` keeps the store in memory (tests, throwaway runs)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._records: List[HistoryRecord] = []
        self.skipped_schema = 0
        if path is not None and os.path.exists(path):
            self._load(path)

    def _load(self, path: str) -> None:
        known = {f.name for f in fields(HistoryRecord)}
        records, self.skipped_schema = load_jsonl(path,
                                                  schema=SCHEMA_VERSION)
        for rec in records:
            try:
                self._records.append(HistoryRecord(
                    **{k: v for k, v in rec.items() if k in known}))
            except TypeError:
                continue        # half-written record with missing fields

    def append(self, records: List[HistoryRecord]) -> None:
        self._records.extend(records)
        if self.path is not None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "a") as f:
                for r in records:
                    f.write(json.dumps(asdict(r)) + "\n")

    def records(self) -> List[HistoryRecord]:
        return list(self._records)

    def __len__(self) -> int:
        return len(self._records)

    def benchmarks(self) -> List[str]:
        return sorted({r.benchmark for r in self._records})

    def commits(self) -> List[str]:
        seen: Dict[str, int] = {}
        for r in self._records:
            seen.setdefault(r.commit_id, r.commit_index)
        return [c for c, _ in sorted(seen.items(), key=lambda kv: kv[1])]

    def series(self, benchmark: str, *, provider: Optional[str] = None,
               mode: Optional[str] = None) -> List[HistoryRecord]:
        """This benchmark's records in commit order (the detector's input).

        The store is append-only across pipeline runs, so a commit may have
        been measured more than once (CI retries, a re-run over the same
        stream): the *latest* record per (suite, provider, mode, commit)
        supersedes earlier ones — re-measurements update the series rather
        than double-counting into the detector's cumulative sums."""
        latest: Dict[tuple, HistoryRecord] = {}
        for r in self._records:
            if r.benchmark != benchmark:
                continue
            if provider is not None and r.provider != provider:
                continue
            if mode is not None and r.mode != mode:
                continue
            latest[(r.suite, r.provider, r.mode, r.commit_id)] = r
        return sorted(latest.values(), key=lambda r: r.commit_index)

    def total_cost(self) -> float:
        return sum(r.cost_dollars for r in self._records)

    def to_sqlite(self, path: str) -> None:
        """Export for ad-hoc SQL (the JSONL stays the source of truth)."""
        cols = [f.name for f in fields(HistoryRecord)]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        con = sqlite3.connect(path)
        try:
            con.execute("DROP TABLE IF EXISTS history")
            con.execute("CREATE TABLE history (%s)" % ", ".join(cols))
            con.executemany(
                "INSERT INTO history VALUES (%s)" % ",".join("?" * len(cols)),
                [tuple(getattr(r, c) for c in cols) for r in self._records])
            con.execute("CREATE INDEX idx_hist_bench ON history "
                        "(benchmark, commit_index)")
            con.commit()
        finally:
            con.close()
