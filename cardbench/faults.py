"""Faults planted underneath the timed path, to see the output check fail.

Each fault is a context manager that patches the program (or the harness's
own pick of the served token) while it is open and restores it on exit.
``tests/test_cardbench_harness.py`` runs a whole tiny cell under each, and
``calibrate.py --fault-seeds`` reads the widest gap under the first at a
cell's own size on the card.
"""
from __future__ import annotations

import contextlib

from cardbench import families


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` set to ``value`` while open, restored on exit."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def state_unchanged(cfg):
    """A decode step that leaves its state as it was, as the family of the
    configuration ``cfg`` keeps it (its module's ``state_unchanged``)."""
    return families.module(cfg).state_unchanged()


@contextlib.contextmanager
def token_altered(cfg):
    """The served token changed where it is produced (the next id)."""
    from cardbench import harness
    pick = harness.pick
    with patched(harness, "pick", lambda logits: (pick(logits) + 1) % logits.shape[-1]):
        yield


FAULTS = {"state_unchanged": state_unchanged, "token_altered": token_altered}
