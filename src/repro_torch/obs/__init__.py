"""Observability: the process-wide context that the engine's and the
pipeline's hook sites read.

The counterpart of ``repro.obs``, for now only its context: ``get_obs``,
``set_obs`` and ``use_obs``.  The port has no ``Observability`` yet (the
tracer, metrics, recorder and monitors are ROADMAP.md §1, "the rest of
obs/"), so ``get_obs()`` stays ``None`` and every hook site is off, as it
is by default in the JAX package.
"""
from __future__ import annotations

import contextlib
from typing import Optional

_OBS: Optional[object] = None


def get_obs() -> Optional[object]:
    """The process-wide observability context (None = fully off)."""
    return _OBS


def set_obs(obs: Optional[object]) -> Optional[object]:
    """Install the context; returns the previous one."""
    global _OBS
    prev, _OBS = _OBS, obs
    return prev


@contextlib.contextmanager
def use_obs(obs: Optional[object]):
    """Scoped install (tests): restores the previous context on exit."""
    prev = set_obs(obs)
    try:
        yield obs
    finally:
        set_obs(prev)


__all__ = ["get_obs", "set_obs", "use_obs"]
