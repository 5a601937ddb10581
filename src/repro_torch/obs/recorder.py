"""Flight recorder: a bounded ring of recent trace events, dumped on
anomalies for post-mortems.

The ``RecordingTracer`` tees every event into the ring; when an anomaly
fires (``InfeasiblePlanError``, a job preemption, a zombie hit or a
timeout-storm burst) the instrumentation calls ``dump(reason, ...)``
and the recorder freezes a copy of the last ``capacity`` events plus
the trigger context.  Dumps are capped at ``max_dumps`` per run so a
fault storm cannot turn the recorder into an unbounded log.
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional

from repro_torch.obs.trace import events_to_chrome


class FlightRecorder:
    """Bounded ring buffer of trace events with capped anomaly dumps."""

    def __init__(self, capacity: int = 2048, max_dumps: int = 8):
        self.capacity = capacity
        self.max_dumps = max_dumps
        self._ring: deque = deque(maxlen=capacity)
        self.dumps: List[dict] = []
        self.dumps_suppressed = 0

    def record(self, event) -> None:
        self._ring.append(event)

    def dump(self, reason: str, *, ts: float = 0.0,
             context: Optional[dict] = None) -> Optional[dict]:
        """Freeze the ring into a post-mortem dump; None once capped."""
        if len(self.dumps) >= self.max_dumps:
            self.dumps_suppressed += 1
            return None
        d = {"reason": reason, "ts": ts, "context": context or {},
             "n_events": len(self._ring),
             "trace": events_to_chrome(list(self._ring))}
        self.dumps.append(d)
        return d

    def snapshot(self) -> dict:
        return {"schema": 1, "capacity": self.capacity,
                "max_dumps": self.max_dumps,
                "dumps_suppressed": self.dumps_suppressed,
                "dumps": self.dumps}
