"""Timing source for real (non-simulated) benchmark execution.

The PyTorch counterpart of ``repro.core.timing``: a callable is timed with
perf_counter after a calibration phase that picks an inner-repeat count so
one measurement takes at least ``min_measure_s`` (Go's -benchtime analogue).
The first call is timed on its own as the cold start (kernel builds, lazy
CUDA init).  ``block`` waits for the card, since CUDA launches return before
the device finishes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch
from torch.utils._pytree import tree_leaves


@dataclass
class Timing:
    seconds_per_call: float
    inner_repeats: int
    compile_seconds: float = 0.0
    cold: bool = False


def block(x):
    """Wait until the device has produced ``x`` (a tensor or a nest of them).

    Walks the whole nest (tuples, lists and dicts at any depth, as
    ``jax.block_until_ready`` does) and synchronises each card that holds
    a leaf, named explicitly: a duet runs on an engine worker thread,
    whose current device need not be the tensor's."""
    devices = {t.device for t in tree_leaves(x)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)
    return x


def time_fn(fn: Callable[[], object], *, min_measure_s: float = 0.02,
            max_inner: int = 1000) -> Timing:
    """Calibrated timing of `fn` (which must block on its own result)."""
    t0 = time.perf_counter()
    fn()                                   # warmup / build
    compile_s = time.perf_counter() - t0

    inner = 1
    while True:
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        dt = time.perf_counter() - t0
        if dt >= min_measure_s or inner >= max_inner:
            return Timing(seconds_per_call=dt / inner, inner_repeats=inner,
                          compile_seconds=compile_s, cold=compile_s > 10 * dt)
        inner = min(max_inner, max(inner * 2,
                                   int(inner * min_measure_s / max(dt, 1e-9))))


def make_timed(fn: Callable, *args, **kwargs) -> Callable[[], float]:
    """Package fn(*args) into a zero-arg timed callable returning seconds
    (duet 'version' interface)."""
    def run() -> float:
        t = time_fn(lambda: block(fn(*args, **kwargs)))
        return t.seconds_per_call
    return run
