"""Duet execution (paper §1/§4, after Bulej et al. [11]).

Both SUT versions live in the *same* instance; a duet pair is one (v1, v2)
timing taken back-to-back (order randomized by RMIT) in that shared
environment.  Only the relative difference of a pair is meaningful.

Here a "version" is any zero-arg callable returning a timing in seconds —
for the PyTorch substrate it is an eager call timed around a device
synchronise (core/timing.py); for the simulated platform it is the
platform model's execution of an abstract workload.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclass
class DuetPair:
    benchmark: str
    v1_seconds: float
    v2_seconds: float
    instance_id: str = ""
    call_index: int = -1
    cold_start: bool = False


class DuetRunnable:
    """A benchmark packaged as a duet: two runnables sharing one setup.

    `setup()` is executed once per instance (the function-image build-cache
    analogue); v1/v2 are then called repeatedly.
    """

    def __init__(self, name: str, v1: Callable[[], float],
                 v2: Callable[[], float],
                 setup: Optional[Callable[[], None]] = None):
        self.name = name
        self.v1 = v1
        self.v2 = v2
        self.setup = setup
        self._setup_done = False

    def ensure_setup(self):
        if self.setup is not None and not self._setup_done:
            self.setup()
            self._setup_done = True

    def run_pair(self, order: Tuple[str, str]) -> Tuple[float, float]:
        """Run one duet pair in the given version order; returns
        (v1_seconds, v2_seconds) regardless of execution order."""
        self.ensure_setup()
        results = {}
        for v in order:
            results[v] = self.v1() if v == "v1" else self.v2()
        return results["v1"], results["v2"]


def collect_pairs(results: Sequence[DuetPair]) -> Dict[str, Tuple[list, list]]:
    """Group duet pairs per benchmark -> (v1 list, v2 list), pair-aligned."""
    out: Dict[str, Tuple[list, list]] = {}
    for r in results:
        v1s, v2s = out.setdefault(r.benchmark, ([], []))
        v1s.append(r.v1_seconds)
        v2s.append(r.v2_seconds)
    return out
