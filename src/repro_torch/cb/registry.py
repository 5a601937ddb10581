"""Benchmark-suite registry (SeBS-style, Copik et al. 2021).

A `BenchmarkSuite` packages a set of microbenchmarks behind one interface
the continuous-benchmarking pipeline can drive: enumerate benchmarks,
fingerprint their code, and measure a subset for one commit, returning the
engine report plus per-benchmark `ChangeResult`s.  Suites register under a
name (`register_suite`) so experiments select them by string — the
synthetic 106-benchmark suite registers here; the port's real kernel
duets register from repro_torch/benchmarks/kernel_bench.py behind the same
interface.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional

from repro_torch.core import rmit, stats
from repro_torch.core.controller import AdaptiveConfig, AdaptiveController
from repro_torch.core.results import analyze
from repro_torch.faas.engine import (EngineConfig, EngineObserver, EngineReport,
                               ExecutionEngine, FanoutObserver)
from repro_torch.cb.commits import Commit


@dataclass
class SuiteRunResult:
    """One suite measurement for one commit."""
    report: EngineReport
    changes: Dict[str, stats.ChangeResult]


class BenchmarkSuite:
    """Registry interface every suite implements.

    `run` measures `benchmarks` for `commit` against its parent version
    (duet-style) and returns the engine report plus the per-benchmark
    change analysis.  An extra engine `observer` may be attached (the
    pipeline uses one to meter per-benchmark invocations and billed
    seconds); implementations must compose it with any observer of their
    own (e.g. the adaptive controller) via `FanoutObserver`.
    """

    name: str = ""

    def benchmark_names(self) -> List[str]:
        raise NotImplementedError

    def run(self, benchmarks: List[str], commit: Commit, *,
            provider: str = "lambda", n_calls: int = 15,
            repeats_per_call: int = 3, parallelism: int = 150,
            memory_mb: int = 2048, seed: int = 0, min_results: int = 10,
            adaptive: bool = False, chaos=None,
            observer: Optional[EngineObserver] = None,
            engine: Optional[str] = None) -> SuiteRunResult:
        """`chaos` is a faas/chaos.py ChaosConfig for simulated suites;
        realtime suites must reject a non-None value.  `engine` selects
        the scheduler core ("fast"/"reference"; None = process default)."""
        raise NotImplementedError

    def job_workloads(self, benchmarks: List[str], commit: Commit) -> Dict:
        """The SimWorkload dict a service job needs to measure
        `benchmarks` for `commit` (parent->commit duets).  Only simulated
        suites can run as service jobs; realtime suites raise."""
        raise NotImplementedError(
            f"suite {self.name!r} cannot run as service jobs")


def _commit_seed(seed: int, commit: Commit) -> int:
    """Each commit's run gets its own deterministic RNG/plan stream."""
    return seed + 1009 * (commit.index + 1)


def run_plan(backend, plan, *, parallelism: int, seed: int,
             min_results: int, adaptive: bool = False,
             observer: Optional[EngineObserver] = None,
             engine: Optional[str] = None) -> SuiteRunResult:
    """Shared engine-run path for every suite: optionally composes the
    AdaptiveController with the caller's observer, and uses the
    controller's analyzer as the final analysis when it decided the run
    (its pair order is the one the stop decisions saw).  ``engine``
    picks the scheduler core ("fast"/"reference", None = process
    default); wave-eligible observers (e.g. the pipeline's benchmark
    meter) ride the vectorized path, while adaptive-controller runs
    stream through the scalar loop (the controller injects work
    mid-flight)."""
    from repro_torch.faas.engine_vec import make_engine
    eng = make_engine(backend, EngineConfig(parallelism=parallelism),
                      engine=engine)
    controller = None
    obs = observer
    if adaptive:
        controller = AdaptiveController(
            plan, AdaptiveConfig(min_results=min_results, seed=seed))
        obs = controller if observer is None \
            else FanoutObserver([controller, observer])
    report = eng.run(plan, observer=obs)
    if controller is not None:
        changes = controller.analyzer.analyze()
    else:
        changes = analyze(report.pairs, seed=seed, min_results=min_results)
    return SuiteRunResult(report=report, changes=changes)


class SyntheticSuite(BenchmarkSuite):
    """The 106-benchmark synthetic suite on the simulated FaaS providers.

    For a commit, each selected benchmark becomes a `SimWorkload` whose v1
    is the parent's cumulative performance level and whose effect is the
    commit's true step — pairwise duet runs measure exactly the
    parent->commit change, like benchmarking two adjacent code versions.
    """

    name = "synthetic"

    def __init__(self, workloads: Optional[Dict] = None):
        if workloads is None:
            from repro_torch.core.experiment import victoriametrics_like_suite
            workloads = victoriametrics_like_suite()
        self.workloads = workloads

    def benchmark_names(self) -> List[str]:
        return sorted(self.workloads)

    def measurable_names(self) -> List[str]:
        """Benchmarks that can execute on the FaaS platform at all."""
        return sorted(n for n, w in self.workloads.items() if not w.fs_write)

    def quiet_names(self, max_sigma: float = 0.024) -> List[str]:
        """Low-noise, always-executable benchmarks (drift candidates)."""
        return sorted(n for n, w in self.workloads.items()
                      if not w.fs_write and w.run_sigma <= max_sigma
                      and not w.unstable_pct)

    def _commit_workloads(self, benchmarks: List[str],
                          commit: Commit) -> Dict:
        out = {}
        for b in benchmarks:
            w = self.workloads[b]
            out[b] = replace(w, base_seconds=w.base_seconds
                             * commit.parent_level(b),
                             effect_pct=commit.step_effect(b))
        return out

    def job_workloads(self, benchmarks: List[str], commit: Commit) -> Dict:
        return self._commit_workloads(benchmarks, commit)

    def run(self, benchmarks: List[str], commit: Commit, *,
            provider: str = "lambda", n_calls: int = 15,
            repeats_per_call: int = 3, parallelism: int = 150,
            memory_mb: int = 2048, seed: int = 0, min_results: int = 10,
            adaptive: bool = False, chaos=None,
            observer: Optional[EngineObserver] = None,
            engine: Optional[str] = None) -> SuiteRunResult:
        from repro_torch.faas.platform import make_provider_backend
        run_seed = _commit_seed(seed, commit)
        plan = rmit.make_plan(sorted(benchmarks), n_calls=n_calls,
                              repeats_per_call=repeats_per_call,
                              seed=run_seed)
        backend = make_provider_backend(
            self._commit_workloads(benchmarks, commit), provider,
            memory_mb=memory_mb, seed=run_seed,
            start_time_s=commit.timestamp_s, chaos=chaos)
        return run_plan(backend, plan, parallelism=parallelism,
                        seed=run_seed, min_results=min_results,
                        adaptive=adaptive, observer=observer,
                        engine=engine)


# ------------------------------------------------------------------ registry
_SUITES: Dict[str, Callable[..., BenchmarkSuite]] = {}


def register_suite(name: str, factory: Callable[..., BenchmarkSuite], *,
                   replace_existing: bool = False) -> None:
    if name in _SUITES and not replace_existing:
        raise ValueError(f"suite {name!r} already registered")
    _SUITES[name] = factory


def get_suite(name: str, **kwargs) -> BenchmarkSuite:
    if name not in _SUITES:
        raise KeyError(f"unknown suite {name!r}; available: "
                       f"{available_suites()}")
    return _SUITES[name](**kwargs)


def available_suites() -> List[str]:
    return sorted(_SUITES)


register_suite("synthetic", SyntheticSuite)
