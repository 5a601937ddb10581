"""Named scopes: a per-thread stack of tags pushed around a region of code
(``named_scope("attention_core")``), as ``jax.named_scope`` names a region
of the JAX package's HLO.  The models mark their regions with it;
``analysis.account`` reads the stack to sum the traffic of a step by tag.
Outside an account a scope costs a list append and pop."""
from __future__ import annotations

import threading
from contextlib import contextmanager

_local = threading.local()


@contextmanager
def named_scope(tag: str):
    """Push ``tag`` for the operations run inside."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append(tag)
    try:
        yield
    finally:
        stack.pop()


def current_scopes() -> tuple:
    """The tags open in this thread, outermost first."""
    return tuple(getattr(_local, "stack", ()))
