"""Statistics-engine performance harness — the repo's perf trajectory.

Measures the three analysis hot paths against a faithful replica of the
seed (pre-vectorization) implementation:

  * ``analyze``   — one batch `results.analyze` over a k-benchmark,
                    n-pair suite vs the seed per-benchmark
                    `detect_change` loop (fresh bootstrap index draw per
                    benchmark, list-of-DuetPair grouping).
  * ``streaming`` — engine-style interleaved pair stream with interim
                    `result()` queries plus a final `analyze()`:
                    dirty-set ring buffers + cached index matrices vs
                    the seed list-append + full-recompute analyzer.
  * ``pipeline``  — a 20-commit continuous-benchmarking run (synthetic
                    suite, mode=full) with the batched analysis vs the
                    same run with the seed per-benchmark analysis
                    monkeypatched in (simulation identical in both, so
                    the delta isolates the analysis path).

Every scenario first asserts the two implementations produce *identical*
results (the batched engine is bit-for-bit the seed statistics), then
times them.  Results go to ``BENCH_stats.json``; the committed copy at
the repo root is the trajectory baseline.  ``--check-baseline`` compares
the measured speedups against that baseline (ratios, so CI machine speed
cancels out) and exits non-zero if the analysis path regressed by more
than 2x.

The port's twin of the JAX package's ``benchmarks/perf_bench.py``, over
the port's copies of the statistics engine and pipeline (host only; no
card).  Its document goes to ``build/bench/`` unless ``--out`` says
otherwise: the ``BENCH_stats.json`` at the checkout's root is the JAX
package's committed baseline.  The seed replica of the streaming analyzer
takes the ``robust`` argument that the adaptive controller passes it.

Usage:
    PYTHONPATH=src python -m repro_torch.benchmarks.perf_bench [--quick]
        [--out build/bench/BENCH_stats.json]
        [--check-baseline BENCH_stats.json]
"""
from __future__ import annotations

import argparse
import json
import platform
import sys
import time
from typing import Dict, List

import numpy as np

from repro_torch.core import stats
from repro_torch.core.duet import DuetPair
from repro_torch.core.results import StreamingAnalyzer, analyze
from repro_torch.core.stats import ChangeResult, relative_diffs


# --------------------------------------------------------- seed replicas
# Faithful copies of the pre-vectorization implementations (PR-2 state of
# core/stats.py / core/results.py): fresh RNG + index draw per bootstrap,
# Python-list accumulation, full per-benchmark recompute.  They are the
# measurement baseline AND the golden reference the batched engine must
# reproduce bit-for-bit.

def legacy_bootstrap_median_ci(x, *, confidence=stats.DEFAULT_CONFIDENCE,
                               n_boot=stats.DEFAULT_BOOTSTRAP, seed=0):
    x = np.asarray(x, dtype=np.float64)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(x), size=(n_boot, len(x)))
    medians = np.median(x[idx], axis=1)
    alpha = (1.0 - confidence) / 2.0
    lo = np.quantile(medians, alpha, method="lower")
    hi = np.quantile(medians, 1.0 - alpha, method="higher")
    return float(np.median(x)), float(lo), float(hi)


def legacy_detect_change(benchmark, v1, v2, *,
                         confidence=stats.DEFAULT_CONFIDENCE,
                         n_boot=stats.DEFAULT_BOOTSTRAP, seed=0,
                         min_results=10):
    v1, v2 = np.asarray(v1), np.asarray(v2)
    n = min(len(v1), len(v2))
    if n < min_results:
        return None
    diffs = relative_diffs(v1[:n], v2[:n])
    med, lo, hi = legacy_bootstrap_median_ci(diffs, confidence=confidence,
                                             n_boot=n_boot, seed=seed)
    changed = lo > 0 or hi < 0
    direction = 0 if not changed else (1 if med > 0 else -1)
    return ChangeResult(benchmark=benchmark, n_pairs=n, median_diff_pct=med,
                        ci_low=lo, ci_high=hi, changed=changed,
                        direction=direction)


def legacy_analyze(pairs, *, confidence=stats.DEFAULT_CONFIDENCE,
                   n_boot=stats.DEFAULT_BOOTSTRAP, seed=0, min_results=10):
    grouped: Dict[str, list] = {}
    for p in pairs:
        grouped.setdefault(p.benchmark, []).append(p)
    out: Dict[str, ChangeResult] = {}
    for name, ps in grouped.items():
        v1 = np.array([p.v1_seconds for p in ps])
        v2 = np.array([p.v2_seconds for p in ps])
        res = legacy_detect_change(name, v1, v2, confidence=confidence,
                                   n_boot=n_boot, seed=seed,
                                   min_results=min_results)
        if res is not None:
            out[name] = res
    return out


class LegacyStreamingAnalyzer:
    """The seed streaming analyzer: per-benchmark Python lists, full
    bootstrap recompute (fresh index draw) whenever the pair count grew.
    API-complete so it can stand in for the adaptive controller's
    analyzer when benchmarking the seed pipeline: the controller passes
    ``robust`` (its config's, "none" by default), and the seed had no
    outlier-fenced CI, so any other value raises."""

    def __init__(self, *, confidence=stats.DEFAULT_CONFIDENCE,
                 n_boot=stats.DEFAULT_BOOTSTRAP, seed=0, min_results=10,
                 robust="none"):
        if robust != "none":
            raise ValueError(f"the seed analyzer has no robust CI "
                             f"(robust={robust!r})")
        self.confidence = confidence
        self.n_boot = n_boot
        self.seed = seed
        self.min_results = min_results
        self._v1: Dict[str, List[float]] = {}
        self._v2: Dict[str, List[float]] = {}
        self._order: List[str] = []
        self._cache: Dict[str, tuple] = {}

    def add_pair(self, pair):
        name = pair.benchmark
        if name not in self._v1:
            self._v1[name] = []
            self._v2[name] = []
            self._order.append(name)
        self._v1[name].append(pair.v1_seconds)
        self._v2[name].append(pair.v2_seconds)

    def add_pairs(self, pairs):
        for p in pairs:
            self.add_pair(p)

    def n_pairs(self, benchmark):
        return len(self._v1.get(benchmark, ()))

    @property
    def benchmarks(self):
        return list(self._order)

    def result(self, benchmark):
        n = len(self._v1.get(benchmark, ()))
        cached = self._cache.get(benchmark)
        if cached is not None and cached[0] == n:
            return cached[1]
        if n == 0:
            return None
        res = legacy_detect_change(benchmark, np.array(self._v1[benchmark]),
                                   np.array(self._v2[benchmark]),
                                   confidence=self.confidence,
                                   n_boot=self.n_boot, seed=self.seed,
                                   min_results=self.min_results)
        self._cache[benchmark] = (n, res)
        return res

    def results(self, benchmarks):
        return {b: self.result(b) for b in benchmarks}

    def analyze(self):
        out = {}
        for name in self._order:
            res = self.result(name)
            if res is not None:
                out[name] = res
        return out


# ------------------------------------------------------------- scenarios
def _suite_pairs(k: int, n_pairs: int, seed: int = 0) -> List[DuetPair]:
    rng = np.random.default_rng(seed)
    pairs = []
    for b in range(k):
        effect = float(rng.uniform(0.96, 1.12))
        v1 = rng.lognormal(0.0, 0.05, n_pairs)
        v2 = v1 * effect * rng.lognormal(0.0, 0.02, n_pairs)
        pairs.append([DuetPair(benchmark=f"b{b:03d}", v1_seconds=float(a),
                               v2_seconds=float(c), call_index=i)
                      for i, (a, c) in enumerate(zip(v1, v2))])
    # engine-style interleave: round-robin across benchmarks
    out = []
    for i in range(n_pairs):
        for b in range(k):
            out.append(pairs[b][i])
    return out


def _time(fn, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def bench_analyze(k: int, n_pairs: int, repeats: int) -> dict:
    pairs = _suite_pairs(k, n_pairs)
    ref = legacy_analyze(pairs, seed=0)
    stats._boot_cache.clear()
    got = analyze(pairs, seed=0)
    assert got == ref, "batched analyze diverged from the seed loop"
    legacy_s = _time(lambda: legacy_analyze(pairs, seed=0), repeats)
    stats._boot_cache.clear()
    cold_s = _time(lambda: analyze(pairs, seed=0), 1)       # incl. idx draw
    batched_s = _time(lambda: analyze(pairs, seed=0), repeats)
    return {"k": k, "n_pairs": n_pairs, "legacy_s": legacy_s,
            "batched_cold_s": cold_s, "batched_s": batched_s,
            "speedup": legacy_s / batched_s}


def bench_streaming(k: int, n_pairs: int, query_every: int,
                    repeats: int) -> dict:
    pairs = _suite_pairs(k, n_pairs, seed=1)

    def run_legacy():
        an = LegacyStreamingAnalyzer(seed=2)
        for i, p in enumerate(pairs):
            an.add_pair(p)
            if i % query_every == 0:
                an.result(p.benchmark)
        return an.analyze()

    def run_new():
        an = StreamingAnalyzer(seed=2)
        for i, p in enumerate(pairs):
            an.add_pair(p)
            if i % query_every == 0:
                an.result(p.benchmark)
        return an.analyze()

    ref = run_legacy()
    stats._boot_cache.clear()
    assert run_new() == ref, "streaming analyzer diverged from the seed one"
    legacy_s = _time(run_legacy, repeats)
    batched_s = _time(run_new, repeats)
    return {"k": k, "n_pairs": n_pairs, "query_every": query_every,
            "legacy_s": legacy_s, "batched_s": batched_s,
            "speedup": legacy_s / batched_s}


def bench_pipeline(commits: int, n_calls: int, repeats: int) -> dict:
    """Adaptive 20-commit continuous-benchmarking run: the controller's
    CI-width stopping rule makes one interim bootstrap check per delivered
    result — the load the seed analysis paid thousands of fresh
    `rng.integers` + `np.median` passes for."""
    from repro_torch.cb import registry
    from repro_torch.core import controller
    from repro_torch.cb.commits import StreamConfig, synthetic_stream
    from repro_torch.cb.pipeline import Pipeline, PipelineConfig
    from repro_torch.cb.registry import get_suite

    names = get_suite("synthetic").benchmark_names()
    stream, _drift = synthetic_stream(
        names, StreamConfig(n_commits=commits, seed=5))

    def run(analysis, analyzer_cls):
        orig = registry.analyze, controller.StreamingAnalyzer
        registry.analyze = analysis
        controller.StreamingAnalyzer = analyzer_cls
        try:
            cfg = PipelineConfig(mode="full", n_calls=n_calls, seed=5,
                                 adaptive=True)
            suite = get_suite("synthetic")
            return Pipeline(suite, cfg).run_stream(stream)
        finally:
            registry.analyze, controller.StreamingAnalyzer = orig

    def run_legacy():
        return run(legacy_analyze, LegacyStreamingAnalyzer)

    def run_new():
        from repro_torch.core.results import StreamingAnalyzer
        return run(analyze, StreamingAnalyzer)

    # the equality-check runs double as the timed runs (a legacy run is
    # minutes at the full shape); both start cold — the seed path has no
    # bootstrap-draw cache, and the batched path's timing includes
    # building its own
    t0 = time.perf_counter()
    ref = run_legacy()
    legacy_s = time.perf_counter() - t0
    stats._boot_cache.clear()
    t0 = time.perf_counter()
    got = run_new()
    batched_s = time.perf_counter() - t0
    for _ in range(max(0, repeats - 1)):
        stats._boot_cache.clear()
        t0 = time.perf_counter()
        run_new()
        batched_s = min(batched_s, time.perf_counter() - t0)
    assert ([c.flagged for c in got.commits]
            == [c.flagged for c in ref.commits]
            and [str(e) for e in got.events] == [str(e) for e in ref.events]
            and got.total_invocations == ref.total_invocations), \
        "batched pipeline diverged from the seed analysis"
    return {"commits": commits, "n_calls": n_calls, "adaptive": True,
            "benchmarks": len(names),
            "legacy_s": legacy_s, "batched_s": batched_s,
            "speedup": legacy_s / batched_s}


# ------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small shapes + 1 repeat (CI smoke)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default="build/bench/BENCH_stats.json")
    ap.add_argument("--check-baseline", metavar="PATH",
                    help="compare speedups against a committed "
                         "BENCH_stats.json; exit 1 on a >2x regression")
    args = ap.parse_args(argv)

    QUICK = {"analyze": (30, 60), "streaming": (12, 40, 5),
             "pipeline": (6, 8)}
    FULL = {"analyze": (100, 200), "streaming": (40, 100, 5),
            "pipeline": (20, 30)}

    def run_profile(shapes, repeats):
        results = {}
        k, n = shapes["analyze"]
        results["analyze"] = bench_analyze(k, n, repeats)
        print(f"  analyze    {k:4d} benchmarks x {n:4d} pairs: "
              f"legacy {results['analyze']['legacy_s']:.3f}s  "
              f"batched {results['analyze']['batched_s']:.3f}s  "
              f"speedup {results['analyze']['speedup']:.1f}x")
        k, n, q = shapes["streaming"]
        results["streaming"] = bench_streaming(k, n, q, repeats)
        print(f"  streaming  {k:4d} benchmarks x {n:4d} pairs: "
              f"legacy {results['streaming']['legacy_s']:.3f}s  "
              f"batched {results['streaming']['batched_s']:.3f}s  "
              f"speedup {results['streaming']['speedup']:.1f}x")
        c, nc = shapes["pipeline"]
        results["pipeline"] = bench_pipeline(c, nc, repeats)
        print(f"  pipeline   {c:4d} commits  x {nc:4d} calls (adaptive): "
              f"legacy {results['pipeline']['legacy_s']:.3f}s  "
              f"batched {results['pipeline']['batched_s']:.3f}s  "
              f"speedup {results['pipeline']['speedup']:.1f}x")
        return results

    profiles = {}
    print("profile: quick")
    profiles["quick"] = run_profile(QUICK, 1)
    if not args.quick:
        print("profile: full")
        profiles["full"] = run_profile(FULL, args.repeats)

    doc = {"schema": 1,
           "env": {"python": platform.python_version(),
                   "numpy": np.__version__,
                   "machine": platform.machine()},
           "profiles": profiles}
    if args.out:
        import os
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        print(f"wrote {args.out}")

    if args.check_baseline:
        with open(args.check_baseline) as f:
            base = json.load(f)["profiles"]
        failed = []
        for prof, results in profiles.items():
            if prof not in base:
                continue
            for name, res in results.items():
                floor = base[prof][name]["speedup"] / 2.0
                if res["speedup"] < floor:
                    failed.append(
                        f"{prof}/{name}: speedup {res['speedup']:.2f}x < "
                        f"half the baseline "
                        f"({base[prof][name]['speedup']:.2f}x)")
        if failed:
            print("PERF REGRESSION vs", args.check_baseline)
            for msg in failed:
                print(" ", msg)
            return 1
        print(f"perf check vs {args.check_baseline}: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
