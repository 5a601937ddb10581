"""Virtual-time tracing: spans/instants on the simulation clock.

A ``Tracer`` collects structured events stamped with *virtual* seconds
(the engine's simulated clock, not wall time) and renders them as Chrome
``trace_event`` JSON so any run opens in Perfetto / chrome://tracing.
Lanes are addressed with string ``(pid, tid)`` pairs — e.g.
``("fleet:lambda", "slot003")`` or ``("tenants", "tenant07")`` — and the
exporter maps them to the integer pid/tid the format requires, emitting
``process_name`` / ``thread_name`` metadata events so the viewer shows
the original names.

The contract that keeps instrumentation zero-perturbation: a tracer only
*reads* values the simulation already computed.  It never draws from an
RNG stream, never mutates engine state, and never reorders deliveries —
which is why every golden digest replays bit-for-bit with a
``RecordingTracer`` attached (tests/test_chaos_identity.py).

``NullTracer`` is the default: ``enabled`` is False, so hot paths that
resolve ``tr = tracer if tracer.enabled else None`` once per run pay a
single attribute read for the whole run.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

# internal event tuples: ("X", name, cat, ts_s, dur_s, pid, tid, args)
#                        ("i", name, cat, ts_s, None,  pid, tid, args)
_Event = Tuple[str, str, str, float, Optional[float], str, str,
               Optional[dict]]


class NullTracer:
    """Inert tracer: every emission is a no-op.  Hot paths check
    ``enabled`` once per run and skip the calls entirely."""

    enabled = False

    def span(self, name: str, *, cat: str, ts: float, dur: float,
             pid: str, tid: str, args: Optional[dict] = None) -> None:
        """A completed interval [ts, ts+dur] in virtual seconds."""

    def instant(self, name: str, *, cat: str, ts: float,
                pid: str, tid: str, args: Optional[dict] = None) -> None:
        """A point event at virtual time ts."""

    def events(self) -> List[_Event]:
        return []

    def to_chrome_trace(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}


class RecordingTracer(NullTracer):
    """Appends every event to an in-memory list (and optionally tees it
    into a FlightRecorder ring for anomaly dumps)."""

    enabled = True

    def __init__(self, recorder=None):
        self._events: List[_Event] = []
        self.recorder = recorder

    def __len__(self) -> int:
        return len(self._events)

    def span(self, name, *, cat, ts, dur, pid, tid, args=None):
        ev = ("X", name, cat, ts, dur, pid, tid, args)
        self._events.append(ev)
        if self.recorder is not None:
            self.recorder.record(ev)

    def instant(self, name, *, cat, ts, pid, tid, args=None):
        ev = ("i", name, cat, ts, None, pid, tid, args)
        self._events.append(ev)
        if self.recorder is not None:
            self.recorder.record(ev)

    def events(self) -> List[_Event]:
        return list(self._events)

    def to_chrome_trace(self) -> dict:
        return events_to_chrome(self._events)


def events_to_chrome(events: List[_Event]) -> dict:
    """Render internal event tuples as a Chrome trace_event document.

    String lanes map to dense integer pid/tid (first-appearance order,
    so the mapping is deterministic for a deterministic run); ``ts`` and
    ``dur`` convert from virtual seconds to integer-ish microseconds.
    """
    pid_of: Dict[str, int] = {}
    tid_of: Dict[Tuple[str, str], int] = {}
    out: List[dict] = []
    meta: List[dict] = []
    for ph, name, cat, ts, dur, pid_s, tid_s, args in events:
        pid = pid_of.get(pid_s)
        if pid is None:
            pid = pid_of[pid_s] = len(pid_of) + 1
            meta.append({"ph": "M", "name": "process_name", "pid": pid,
                         "tid": 0, "args": {"name": pid_s}})
        tkey = (pid_s, tid_s)
        tid = tid_of.get(tkey)
        if tid is None:
            tid = tid_of[tkey] = len(tid_of) + 1
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": tid, "args": {"name": tid_s}})
        ev = {"ph": ph, "name": name, "cat": cat,
              "ts": round(ts * 1e6, 3), "pid": pid, "tid": tid}
        if ph == "X":
            ev["dur"] = round(max(0.0, dur) * 1e6, 3)
        if ph == "i":
            ev["s"] = "t"                 # instant scoped to its thread
        if args:
            ev["args"] = args
        out.append(ev)
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def validate_chrome_trace(doc) -> List[str]:
    """Hand-rolled structural validation of a Chrome trace_event JSON
    document (the container ships no jsonschema).  Returns a list of
    violations; empty means Perfetto/chrome://tracing will load it."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents is missing or not an array"]
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or len(ph) != 1:
            errors.append(f"{where}: missing/invalid ph")
            continue
        if not isinstance(ev.get("name"), str):
            errors.append(f"{where}: missing name")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                errors.append(f"{where}: {key} must be an integer")
        if ph == "M":
            if not isinstance(ev.get("args"), dict):
                errors.append(f"{where}: metadata event without args")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"{where}: ts must be a non-negative number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: X event needs non-negative dur")
        if "args" in ev and not isinstance(ev["args"], dict):
            errors.append(f"{where}: args must be an object")
        if len(errors) >= 50:
            errors.append("... (truncated)")
            break
    return errors


def write_chrome_trace(doc: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
