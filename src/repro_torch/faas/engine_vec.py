"""Engine factory.

The counterpart of ``repro.faas.engine_vec``, for now only its factory:
``make_engine``, ``set_default_engine`` and the process default.  The
vectorised engine (``VectorEngine``, ``PairSeq``) is ROADMAP.md §1, "the
rest of faas/engine_vec.py"; until it lands every run takes the scalar
``ExecutionEngine``.  The JAX package guarantees that both engines give
identical reports, and it runs every realtime backend on the scalar loop
anyway.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.faas.engine import EngineConfig, ExecutionEngine

_DEFAULT_ENGINE = "reference"

_NO_FAST = ("the vectorised engine (engine='fast') is not ported yet: "
            "ROADMAP.md §1, the rest of faas/engine_vec.py; use "
            "engine='reference' (identical reports)")


def _check(engine: str) -> None:
    if engine == "fast":
        raise NotImplementedError(_NO_FAST)
    if engine != "reference":
        raise ValueError(f"unknown engine {engine!r} "
                         "(expected 'fast' or 'reference')")


def set_default_engine(engine: str) -> None:
    """Process-wide default used by ``make_engine(engine=None)`` callers —
    the funnel for ``--engine fast|reference`` CLI flags."""
    _check(engine)
    global _DEFAULT_ENGINE
    _DEFAULT_ENGINE = engine


def make_engine(backend, cfg: Optional[EngineConfig] = None, *,
                engine: Optional[str] = None):
    """Engine factory: ``reference`` (the scalar event loop) and ``None``
    (the process default) give an ``ExecutionEngine``; ``fast`` raises
    until the vectorised engine is ported."""
    if engine is None:
        engine = _DEFAULT_ENGINE
    _check(engine)
    return ExecutionEngine(backend, cfg)
