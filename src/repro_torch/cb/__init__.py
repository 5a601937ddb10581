"""Continuous-benchmarking pipeline: commit streams, benchmark selection,
result caching, and regression history.

The paper's value proposition is running microbenchmark suites
*continuously* in CI/CD; this package turns the single commit-pair
evaluator (faas/engine.py + core/controller.py) into that pipeline:

::

    CommitStream        per-commit code fingerprints + ground truth
      (commits.py)                 │
                                   ▼
    BenchmarkSelector   run only fingerprint-changed benchmarks,
      (select.py)       A/A-revalidate stale unchanged ones
                                   │
    ResultCache         reuse measurements of identical
      (cache.py)        (fingerprint-pair, config) keys
                                   │
                                   ▼
    BenchmarkSuite      suite registry (SeBS-style): the synthetic
      (registry.py)     106-benchmark suite and the port's real kernel
                        duets (repro_torch/benchmarks/kernel_bench.py)
                        behind one interface, all running on the
                        ExecutionEngine
                                   │
                                   ▼
    HistoryStore        schema-versioned JSONL/SQLite: per-commit
      (history.py)      per-benchmark CIs, invocations, costs
                                   │
                                   ▼
    RegressionDetector  changepoint/CUSUM over the history: flags slow
      (detect.py)       drifts no single pairwise comparison can see

`Pipeline` (pipeline.py) orchestrates the layers per commit;
`repro_torch.cb.cli` is the command-line/CI entry point.
"""
from repro_torch.cb.cache import ResultCache, config_digest
from repro_torch.cb.commits import (Commit, DriftSpec, StreamConfig, code_digest,
                              synthetic_stream)
from repro_torch.cb.detect import (DetectorConfig, RegressionDetector,
                             RegressionEvent, SeriesPoint, record_to_point)
from repro_torch.cb.history import (HistoryRecord, HistoryStore, SOURCE_BASELINE,
                              SOURCE_CACHE, SOURCE_RUN, SOURCE_SKIP)
from repro_torch.cb.pipeline import (CommitRun, MODES, Pipeline, PipelineConfig,
                               PipelineReport, run_pipeline)
from repro_torch.cb.registry import (BenchmarkSuite, SuiteRunResult, SyntheticSuite,
                               available_suites, get_suite, register_suite)
from repro_torch.cb.select import BenchmarkSelector, Selection, SelectorConfig

__all__ = [
    "BenchmarkSelector", "BenchmarkSuite", "Commit", "CommitRun",
    "DetectorConfig", "DriftSpec", "HistoryRecord", "HistoryStore", "MODES",
    "Pipeline", "PipelineConfig", "PipelineReport", "RegressionDetector",
    "RegressionEvent", "ResultCache", "Selection", "SelectorConfig",
    "SeriesPoint", "SOURCE_BASELINE", "SOURCE_CACHE", "SOURCE_RUN",
    "SOURCE_SKIP", "StreamConfig", "SuiteRunResult", "SyntheticSuite",
    "available_suites", "code_digest", "config_digest", "get_suite",
    "record_to_point", "register_suite", "run_pipeline", "synthetic_stream",
]
