"""Real-timing microbenchmarks of the port's hot layers, on the CUDA card.

The counterpart of the JAX package's ``benchmarks/kernel_bench.py``: the
suite of kernel duets that ElastiBench runs for this substrate, each a
plain implementation against an optimised one, timed by the calibrated
duet harness (``repro_torch.core.timing``) and registered as ``"kernels"``
in the port's suite registry when this module is imported.

The duets run eagerly (no ``torch.compile``, so nothing compiles inside a
timed window) on the device the suite is given, the CUDA card unless the
caller asks for the CPU.  On the card the SSD duet's chunked side is the
hand-written K2 kernel (``models/ssm.py::ssd_chunked``), so its
fingerprint covers K2's CUDA source too.  At the suite's shapes the card
is mostly idle: a duet's time there is largely launch and synchronise
overhead (PERF.md).
"""
from __future__ import annotations

import importlib
import inspect
import time
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.cb.commits import Commit, code_digest
from repro_torch.cb.registry import (BenchmarkSuite, SuiteRunResult,
                                     register_suite, run_plan)
from repro_torch.core import rmit
from repro_torch.core.controller import ControllerConfig, ElasticController
from repro_torch.core.duet import DuetRunnable
from repro_torch.core.results import analyze
from repro_torch.core.timing import make_timed
from repro_torch.faas.backends import LocalDuetBackend
from repro_torch.kernels.build import CSRC
from repro_torch.kernels.ref import ssd_ref
from repro_torch.models.attention import attention_chunked, attention_dot
from repro_torch.models.layers import rms_norm
from repro_torch.models.lm import resolve_device
from repro_torch.models.ssm import ssd_chunked


# --------------------------------------------------------- the duets' versions
# Each takes the tensors its input draw returns, so that a test can feed the
# same numpy arrays to these and to the JAX suite's functions.
def attention_v1(q, k, v):
    return attention_dot(q, k, v, causal=True)


def attention_v2(q, k, v):
    return attention_chunked(q, k, v, causal=True, chunk=64)


def ssd_v1(x, dt, A, Bi, Ci):
    """The exact recurrence, step by step, on the head-major layout."""
    return ssd_ref(x.movedim(1, 2), dt.movedim(1, 2), A, Bi.movedim(1, 2),
                   Ci.movedim(1, 2))[0]


def ssd_v2(x, dt, A, Bi, Ci):
    """The chunked scan: K2 on the card, its plain version on the CPU."""
    return ssd_chunked(x, dt, A, Bi, Ci, chunk=64)[0]


def rmsnorm_v1(x, w):
    """The unfused formula, one elementwise op at a time."""
    return (x / torch.sqrt(torch.mean(x * x, -1, keepdim=True) + 1e-6)) * (1 + w)


def rmsnorm_v2(x, w):
    return rms_norm(x, w, 1e-6)


# ------------------------------------------------------------- input draws
def _normal(g, shape, device):
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32)


def attention_inputs(B=1, S=256, H=4, hd=64, *, device):
    """q, k, v [B, S, H, hd] f32 from a generator seeded 0."""
    g = torch.Generator(device=device).manual_seed(0)
    return tuple(_normal(g, (B, S, H, hd), device) for _ in range(3))


def ssd_inputs(B=1, S=512, H=4, P=32, N=32, *, device):
    """x [B,S,H,P], dt [B,S,H], A [H], B/C [B,S,1,N] f32 from a generator
    seeded 1, distributed as the JAX suite draws them."""
    g = torch.Generator(device=device).manual_seed(1)
    x = _normal(g, (B, S, H, P), device)
    dt = F.softplus(_normal(g, (B, S, H), device))
    A = -torch.exp(_normal(g, (H,), device) * 0.5)
    Bi = _normal(g, (B, S, 1, N), device) * 0.5
    Ci = _normal(g, (B, S, 1, N), device) * 0.5
    return x, dt, A, Bi, Ci


def rmsnorm_inputs(T=4096, D=512, *, device):
    """x [T, D] f32 from a generator seeded 2 and a zero weight [D]."""
    g = torch.Generator(device=device).manual_seed(2)
    return _normal(g, (T, D), device), torch.zeros((D,), device=device)


# (name, v1, v2, input draw, the draw's shape for small=True); the draw's
# defaults are the suite's shapes, those of the JAX suite
DUETS = (
    ("attention_dot_vs_chunked", attention_v1, attention_v2, attention_inputs,
     dict(S=64)),
    ("ssd_recurrence_vs_chunked", ssd_v1, ssd_v2, ssd_inputs, dict(S=128, P=16, N=16)),
    ("rmsnorm_fused_vs_unfused", rmsnorm_v1, rmsnorm_v2, rmsnorm_inputs,
     dict(T=512, D=128)),
)


def make_duets(*, small: bool = False, device) -> Dict[str, DuetRunnable]:
    """The three duets on ``device``, at the suite's shapes (``small`` for
    CI), each version timed by ``make_timed`` on its input draw."""
    duets = {}
    for name, v1, v2, draw, small_shape in DUETS:
        inputs = draw(**(small_shape if small else {}), device=device)
        duets[name] = DuetRunnable(name, make_timed(v1, *inputs), make_timed(v2, *inputs))
    return duets


# ------------------------------------------------ registry-backed real suite
# which sources implement each duet: editing any of them changes the
# benchmark's code fingerprint, which is what drives pipeline selection.
# On the card ssd_chunked is K2, so its CUDA source (kernels/csrc) counts.
_FP_MODULES = {
    "attention_dot_vs_chunked": ("repro_torch.models.attention",),
    "ssd_recurrence_vs_chunked": ("repro_torch.kernels.ref",
                                  "repro_torch.models.ssm",
                                  "repro_torch.kernels.ssd_scan"),
    "rmsnorm_fused_vs_unfused": ("repro_torch.models.layers",),
}
_FP_CUDA = {"ssd_recurrence_vs_chunked": ("ssd_scan.cu", "*.cuh")}


def _module_source(name: str) -> str:
    return inspect.getsource(importlib.import_module(name))


def _cuda_sources(patterns) -> List[str]:
    texts = []
    for pattern in patterns:
        paths = sorted(CSRC.glob(pattern))
        if not paths:
            raise FileNotFoundError(f"no CUDA source {pattern} in {CSRC}")
        texts += [p.read_text() for p in paths]
    return texts


def kernel_fingerprints() -> Dict[str, str]:
    """Content digests of the *actual* implementation sources."""
    return {bench: code_digest(*[_module_source(m) for m in mods],
                               *_cuda_sources(_FP_CUDA.get(bench, ())))
            for bench, mods in _FP_MODULES.items()}


def kernel_commits() -> List[Commit]:
    """Two-version stream for the working tree: the reference
    implementations as the baseline, the optimized implementations as the
    head commit.  Every benchmark's fingerprint differs between the two, so
    the pipeline selects and really measures all of them."""
    fps = kernel_fingerprints()
    base = {b: code_digest("reference", fp) for b, fp in fps.items()}
    head = {b: code_digest("optimized", fp) for b, fp in fps.items()}
    return [
        Commit(commit_id="reference", index=0, parent=None, timestamp_s=0.0,
               fingerprints=base),
        Commit(commit_id="head", index=1, parent="reference", timestamp_s=0.0,
               fingerprints=head, touched=tuple(sorted(head))),
    ]


class KernelSuite(BenchmarkSuite):
    """The port's kernel duets behind the same registry interface as the
    synthetic suite: the pipeline runs a real workload end to end with real
    timings on ``device`` (the CUDA card unless the caller passes
    ``device="cpu"``; asking for an absent card raises).  ``small=True``
    shrinks the shapes for CI."""

    name = "kernels"

    def __init__(self, *, small: bool = False, device="cuda"):
        self.small = bool(small)
        self.device = resolve_device(device)
        self._duets: Optional[Dict[str, DuetRunnable]] = None

    def _build(self) -> Dict[str, DuetRunnable]:
        if self._duets is None:
            self._duets = make_duets(small=self.small, device=self.device)
        return self._duets

    def benchmark_names(self) -> List[str]:
        return sorted(_FP_MODULES)

    def run(self, benchmarks: List[str], commit: Commit, *,
            provider: str = "local", n_calls: int = 12,
            repeats_per_call: int = 1, parallelism: int = 1,
            memory_mb: int = 0, seed: int = 0, min_results: int = 10,
            adaptive: bool = False, chaos=None,
            observer=None, engine=None) -> SuiteRunResult:
        if chaos is not None:
            raise ValueError("fault injection wraps virtual-time backends; "
                             "the kernel suite runs real timings")
        duets = {b: self._build()[b] for b in benchmarks}
        plan = rmit.make_plan(sorted(duets), n_calls=n_calls,
                              repeats_per_call=repeats_per_call, seed=seed)
        backend = LocalDuetBackend(duets, benchmark_timeout_s=60.0)
        # real duets on one card (or one CPU host): wide parallelism would
        # have the versions contend with each other instead of measuring
        # them; two duets on one GPU would share its SMs and its stream
        cap = 1 if self.device.type == "cuda" else 2
        return run_plan(backend, plan,
                        parallelism=max(1, min(parallelism, cap)),
                        seed=seed, min_results=min_results,
                        adaptive=adaptive, observer=observer,
                        engine=engine)


register_suite("kernels", KernelSuite, replace_existing=True)


def table_kernel_duets(device="cuda"):
    """Duet-benchmark the port's implementations on ``device`` via the
    elastic controller (bounded parallelism=1: correctness of the pipeline,
    not fleet timing)."""
    t0 = time.perf_counter()
    duets = make_duets(device=resolve_device(device))
    plan = rmit.make_plan(sorted(duets), n_calls=12, repeats_per_call=1, seed=3)
    ctl = ElasticController(duets, ControllerConfig(max_parallelism=1,
                                                    benchmark_timeout_s=60.0,
                                                    min_results=10))
    report = ctl.run_suite(plan)
    changes = analyze(report.pairs, min_results=10)
    harness_us = (time.perf_counter() - t0) * 1e6
    rows = {}
    for name, c in sorted(changes.items()):
        rows[name] = {
            "median_diff_pct": round(c.median_diff_pct, 2),
            "ci": [round(c.ci_low, 2), round(c.ci_high, 2)],
            "changed": c.changed, "n": c.n_pairs,
        }
    rows["wall_s"] = round(report.wall_seconds, 1)
    rows["invocations"] = report.invocations_done
    return "kernel_duets_real", harness_us, rows
