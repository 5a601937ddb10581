"""Faults planted underneath the timed path, to see the output check fail.

Each fault is a context manager that patches the program (or the harness's
own pick of the served token) while it is open and restores it on exit.
``tests/test_cardbench_harness.py`` runs a whole tiny cell under each, and
``calibrate.py --fault-seeds`` reads the widest gap under the first at a
cell's own size on the card.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def state_unchanged(family: str):
    """A decode step that leaves its state as it was: the dense cache never
    gets the new key and value, the Mamba-2 step returns the SSM and conv
    states it was given."""
    from repro_torch.models import lm, ssm
    if family == "dense":
        with _patched(lm, "_write_pos", lambda buf, pos, val: None):
            yield
        return
    block = ssm.mamba_block

    def frozen(u, p, cfg, h0=None, conv0=None, decode=False):
        out, states = block(u, p, cfg, h0=h0, conv0=conv0, decode=decode)
        return out, ((h0, conv0) if decode else states)
    with _patched(ssm, "mamba_block", frozen):
        yield


@contextlib.contextmanager
def token_altered(family: str):
    """The served token changed where it is produced (the next id)."""
    from cardbench import harness
    pick = harness.pick
    with _patched(harness, "pick", lambda logits: (pick(logits) + 1) % logits.shape[-1]):
        yield


FAULTS = {"state_unchanged": state_unchanged, "token_altered": token_altered}
