"""Fingerprint-keyed result cache.

A measured `ChangeResult` is reusable whenever the *exact* code-version
pair recurs under the same measurement configuration: the A/A guard runs
the selector schedules for stale unchanged benchmarks (same fingerprint on
both sides) hit after their first measurement, as do re-evaluations of a
previously measured pair (CI retries, reverts re-landing).  Entries record
what the original measurement cost, so a hit's saving is attributable.

Persistence is append-only JSONL with a schema version per record —
crash-tolerant the same way core/results.py is (torn tail lines are
ignored on load), mergeable across pipeline runs.
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import asdict, dataclass
from typing import Dict, Optional

from repro_torch.core.results import load_jsonl
from repro_torch.core.stats import ChangeResult

SCHEMA_VERSION = 1


def config_digest(**kw) -> str:
    """Digest of every knob that makes two measurements comparable."""
    blob = json.dumps(kw, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclass
class CacheEntry:
    schema: int
    benchmark: str
    fp_v1: str                      # parent-version fingerprint
    fp_v2: str                      # commit-version fingerprint
    config: str                     # config_digest of the measurement setup
    change: Optional[dict]          # asdict(ChangeResult); None if unanalyzable
    invocations: int
    billed_seconds: float
    cost_dollars: float

    @property
    def key(self) -> str:
        return cache_key(self.benchmark, self.fp_v1, self.fp_v2, self.config)

    def change_result(self) -> Optional[ChangeResult]:
        return None if self.change is None else ChangeResult(**self.change)


def cache_key(benchmark: str, fp_v1: str, fp_v2: str, config: str) -> str:
    return f"{benchmark}:{fp_v1}:{fp_v2}:{config}"


class ResultCache:
    """In-memory map with optional JSONL persistence (path=None keeps it
    purely in-memory).  Loading skips records from unknown future schemas
    rather than failing — an old reader never misinterprets new fields."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._entries: Dict[str, CacheEntry] = {}
        self.hits = 0
        self.misses = 0
        self.skipped_schema = 0
        if path is not None and os.path.exists(path):
            self._load(path)

    def _load(self, path: str) -> None:
        records, self.skipped_schema = load_jsonl(path,
                                                  schema=SCHEMA_VERSION)
        for rec in records:
            try:
                e = CacheEntry(**rec)
            except TypeError:
                continue        # half-written record with missing fields
            self._entries[e.key] = e

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, benchmark: str, fp_v1: str, fp_v2: str,
            config: str) -> Optional[CacheEntry]:
        e = self._entries.get(cache_key(benchmark, fp_v1, fp_v2, config))
        if e is None:
            self.misses += 1
        else:
            self.hits += 1
        return e

    def put(self, benchmark: str, fp_v1: str, fp_v2: str, config: str, *,
            change: Optional[ChangeResult], invocations: int,
            billed_seconds: float, cost_dollars: float) -> CacheEntry:
        e = CacheEntry(schema=SCHEMA_VERSION, benchmark=benchmark,
                       fp_v1=fp_v1, fp_v2=fp_v2, config=config,
                       change=None if change is None else asdict(change),
                       invocations=invocations,
                       billed_seconds=billed_seconds,
                       cost_dollars=cost_dollars)
        self._entries[e.key] = e
        if self.path is not None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(asdict(e)) + "\n")
        return e
