"""Result store: JSONL persistence + per-experiment aggregation.

Every duet pair is one JSONL record — append-only, crash-tolerant (a torn
final line is ignored on load), mergeable across workers.  An experiment's
analysis (core/stats) reads pair-aligned v1/v2 timings per benchmark.

Two analysis paths share the same statistics:

  * `analyze(pairs)` — batch: one pass over a finished result set, all
    benchmarks bootstrapped together through `stats.detect_changes_batch`.
  * `StreamingAnalyzer` — incremental: pairs land in growable NumPy
    buffers and a dirty-set records which benchmarks received new pairs;
    `analyze()` re-bootstraps only the dirty ones, in one batched call.
    This is what the adaptive controller's CI-width stopping rule
    consumes.  On the same pairs and parameters the two paths produce
    identical results (bit-for-bit, including the bootstrap CIs).
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.duet import DuetPair
from repro_torch.core.stats import (ChangeResult, DEFAULT_BOOTSTRAP,
                              DEFAULT_CONFIDENCE, detect_change,
                              detect_changes_batch)


def append_pairs(path: str, pairs: Iterable[DuetPair]):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "ab") as f:
        if f.tell() > 0:
            # heal a torn tail from a previous crash: without the newline
            # the first new record would glue onto the half-written line
            # and both would be lost on load
            with open(path, "rb") as r:
                r.seek(-1, os.SEEK_END)
                torn = r.read(1) != b"\n"
            if torn:
                f.write(b"\n")
        for p in pairs:
            f.write((json.dumps(asdict(p)) + "\n").encode())


def load_jsonl(path: str, *, schema: Optional[int] = None) -> Tuple[list,
                                                                    int]:
    """Crash-tolerant JSONL loader shared by every append-only store
    (duet pairs here, the cb result cache and history store): blank and
    torn/corrupt lines are skipped; with `schema` set, records whose
    ``schema`` field differs are dropped and counted (an old reader never
    misinterprets a future format).  Returns (records, n_skipped_schema)."""
    records: list = []
    skipped_schema = 0
    if not os.path.exists(path):
        return records, skipped_schema
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue    # torn tail line after a crash
            if schema is not None and rec.get("schema") != schema:
                skipped_schema += 1
                continue
            records.append(rec)
    return records, skipped_schema


def load_pairs(path: str) -> List[DuetPair]:
    records, _ = load_jsonl(path)
    out: List[DuetPair] = []
    for rec in records:
        try:
            out.append(DuetPair(**rec))
        except TypeError:
            continue        # half-written record with missing fields
    return out


def analyze(pairs: Iterable[DuetPair], *, confidence: float = DEFAULT_CONFIDENCE,
            n_boot: int = DEFAULT_BOOTSTRAP, seed: int = 0,
            min_results: int = 10, robust: str = "none",
            robust_k: float = 4.0) -> Dict[str, ChangeResult]:
    """Per-benchmark change detection over pair-aligned duet results.

    One `detect_changes_batch` call bootstraps the whole suite; identical
    to a per-benchmark `detect_change` loop, several times faster.
    ``robust="trim"``/``"winsor"`` opts into the outlier-fenced CI
    variants (stats.py) — identical on outlier-free data, resistant to
    chaos-contaminated pairs otherwise.

    Array-backed pair sequences from the vectorized engine (`PairSeq`)
    are grouped straight from their columns — same benchmarks, same
    first-appearance order, same ascending index sets as the object
    loop, without materializing a DuetPair per row."""
    seq = _pairseq_columns(pairs)
    if seq is not None:
        bid, v1, v2, names = seq
        combos: Dict[str, list] = {}
        cu, first = np.unique(bid, return_index=True)
        for c in cu[np.argsort(first)].tolist():
            combos.setdefault(names[c], []).append(c)
        return detect_changes_batch(
            ((name, v1[ix], v2[ix]) for name, ix in
             ((n, np.flatnonzero(np.isin(bid, cs)) if len(cs) > 1
               else np.flatnonzero(bid == cs[0]))
              for n, cs in combos.items())),
            confidence=confidence, n_boot=n_boot, seed=seed,
            min_results=min_results, robust=robust, robust_k=robust_k)
    pairs = pairs if isinstance(pairs, list) else list(pairs)
    v1 = np.array([p.v1_seconds for p in pairs])
    v2 = np.array([p.v2_seconds for p in pairs])
    grouped: Dict[str, list] = {}
    for i, p in enumerate(pairs):
        g = grouped.get(p.benchmark)
        if g is None:
            g = grouped[p.benchmark] = []
        g.append(i)
    return detect_changes_batch(
        ((name, v1[ix], v2[ix])
         for name, ix in grouped.items()),
        confidence=confidence, n_boot=n_boot, seed=seed,
        min_results=min_results, robust=robust, robust_k=robust_k)


def _pairseq_columns(pairs):
    """(bid, v1, v2, names) when `pairs` is an array-backed PairSeq
    (timing columns round-trip bit-exactly through materialization, so
    the column path and the object path see identical floats)."""
    try:
        from repro_torch.faas.engine_vec import PairSeq
    except ImportError:                       # pragma: no cover
        return None
    if isinstance(pairs, PairSeq):
        return pairs._bid, pairs._v1, pairs._v2, pairs._names
    return None


class _PairBuffer:
    """Growable pair-aligned v1/v2 timing arrays (amortized doubling), so
    the streaming path never rebuilds Python lists into fresh ndarrays."""

    __slots__ = ("v1", "v2", "n")

    def __init__(self, capacity: int = 32):
        self.v1 = np.empty(capacity)
        self.v2 = np.empty(capacity)
        self.n = 0

    def append(self, a: float, b: float) -> None:
        if self.n == len(self.v1):
            self.v1 = np.concatenate([self.v1, np.empty(len(self.v1))])
            self.v2 = np.concatenate([self.v2, np.empty(len(self.v2))])
        self.v1[self.n] = a
        self.v2[self.n] = b
        self.n += 1

    def extend(self, a: np.ndarray, b: np.ndarray) -> None:
        need = self.n + int(a.shape[0])
        cap = len(self.v1)
        if need > cap:
            while cap < need:
                cap *= 2
            v1 = np.empty(cap)
            v2 = np.empty(cap)
            v1[:self.n] = self.v1[:self.n]
            v2[:self.n] = self.v2[:self.n]
            self.v1, self.v2 = v1, v2
        self.v1[self.n:need] = a
        self.v2[self.n:need] = b
        self.n = need

    def views(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.v1[:self.n], self.v2[:self.n]


class StreamingAnalyzer:
    """Incremental per-benchmark change detection.

    Pair-aligned v1/v2 timings accumulate in growable NumPy buffers; a
    dirty-set records which benchmarks have received pairs since their
    last `ChangeResult` was computed.  `result()` re-bootstraps one dirty
    benchmark; `analyze()` (and `results()`) re-bootstrap *all* dirty
    benchmarks in a single `stats.detect_changes_batch` call and serve the
    rest from cache.  `analyze()` over everything added so far is
    bit-for-bit the batch `analyze()` on the same pairs (same
    confidence/n_boot/seed)."""

    def __init__(self, *, confidence: float = DEFAULT_CONFIDENCE,
                 n_boot: int = DEFAULT_BOOTSTRAP, seed: int = 0,
                 min_results: int = 10, robust: str = "none"):
        self.confidence = confidence
        self.n_boot = n_boot
        self.seed = seed
        self.min_results = min_results
        self.robust = robust
        self._buf: Dict[str, _PairBuffer] = {}
        self._order: List[str] = []           # insertion order, like analyze()
        self._dirty: set = set()
        self._cache: Dict[str, Optional[ChangeResult]] = {}

    def add_pair(self, pair: DuetPair) -> None:
        name = pair.benchmark
        buf = self._buf.get(name)
        if buf is None:
            buf = self._buf[name] = _PairBuffer()
            self._order.append(name)
        buf.append(pair.v1_seconds, pair.v2_seconds)
        self._dirty.add(name)

    def add_pairs(self, pairs: Iterable[DuetPair]) -> None:
        seq = _pairseq_columns(pairs)
        if seq is not None:
            bid, v1, v2, names = seq
            combos: Dict[str, list] = {}
            cu, first = np.unique(bid, return_index=True)
            for c in cu[np.argsort(first)].tolist():
                combos.setdefault(names[c], []).append(c)
            for name, cs in combos.items():
                m = (bid == cs[0]) if len(cs) == 1 else np.isin(bid, cs)
                self.append_many(name, v1[m], v2[m])
            return
        for p in pairs:
            self.add_pair(p)

    def append_many(self, benchmark: str, v1, v2) -> None:
        """Bulk pair append (vectorized-engine wave flush): identical
        end state to `add_pair` per element in order, independent of how
        the stream is chunked into calls."""
        v1 = np.asarray(v1, float).ravel()
        v2 = np.asarray(v2, float).ravel()
        if v1.shape != v2.shape:
            raise ValueError("v1/v2 must be pair-aligned")
        if not v1.size:
            return
        buf = self._buf.get(benchmark)
        if buf is None:
            buf = self._buf[benchmark] = _PairBuffer()
            self._order.append(benchmark)
        buf.extend(v1, v2)
        self._dirty.add(benchmark)

    def n_pairs(self, benchmark: str) -> int:
        buf = self._buf.get(benchmark)
        return 0 if buf is None else buf.n

    @property
    def benchmarks(self) -> List[str]:
        return list(self._order)

    def result(self, benchmark: str) -> Optional[ChangeResult]:
        """ChangeResult over the pairs seen so far (None below min_results);
        cached until new pairs for this benchmark arrive."""
        buf = self._buf.get(benchmark)
        if buf is None:
            return None
        if benchmark not in self._dirty:
            return self._cache.get(benchmark)
        v1, v2 = buf.views()
        res = detect_change(benchmark, v1, v2,
                            confidence=self.confidence, n_boot=self.n_boot,
                            seed=self.seed, min_results=self.min_results,
                            robust=self.robust)
        self._cache[benchmark] = res
        self._dirty.discard(benchmark)
        return res

    def results(self, benchmarks: Sequence[str]) -> Dict[str,
                                                         Optional[ChangeResult]]:
        """Current `ChangeResult` (or None) per requested benchmark; all
        dirty ones among them are re-bootstrapped in one batched call."""
        todo = [b for b in benchmarks if b in self._dirty and b in self._buf]
        if todo:
            fresh = detect_changes_batch(
                ((b,) + self._buf[b].views() for b in todo),
                confidence=self.confidence, n_boot=self.n_boot,
                seed=self.seed, min_results=self.min_results,
                robust=self.robust)
            for b in todo:
                self._cache[b] = fresh.get(b)
                self._dirty.discard(b)
        return {b: self._cache.get(b) for b in benchmarks}

    def analyze(self) -> Dict[str, ChangeResult]:
        """Batch-equivalent view of everything streamed so far."""
        res = self.results(self._order)
        return {name: r for name, r in res.items() if r is not None}
