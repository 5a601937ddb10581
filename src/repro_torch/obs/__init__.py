"""Observability: virtual-time tracing, metrics, and a flight recorder.

The port's copy of ``repro.obs`` (NumPy only).

Architecture
============

::

                     get_obs() ──► Observability
                                    ├── tracer   (trace.py: spans/instants
                                    │             on the virtual clock,
                                    │             Chrome trace_event export)
                                    ├── metrics  (metrics.py: counters /
                                    │             gauges / quantile sketches
                                    │             / windowed rings, labels
                                    │             tenant,provider,benchmark)
                                    ├── recorder (recorder.py: bounded ring,
                                    │             anomaly dumps)
                                    └── monitor  (slo.py: declarative SLO
                                                  evaluators + detectors.py
                                                  anomaly banks; incidents.py
                                                  joins their alerts with
                                                  trace/dump evidence)

The passive layer (tracer/metrics/recorder, ``recording()`` mode) only
records; the active layer (``monitoring()`` mode) additionally watches
the stream: ``obs/slo.py`` compiles declarative ``SLOSpec``s into
incremental evaluators with multi-window burn-rate alerting,
``obs/detectors.py`` runs streaming anomaly detectors (EWMA z-score
with hysteresis, rate spikes, stuck gauges) over the windowed-sample
rings in ``obs/metrics.py``, and ``obs/incidents.py`` clusters their
alerts with co-occurring trace instants and flight-recorder dumps into
root-cause incident records.  Both layers are driven purely by the
virtual clock — alerts and incidents are bit-reproducible — and both
honor the same zero-perturbation contract.  ``repro_torch.obs.watch`` turns a
monitor snapshot into a machine-readable health verdict (non-zero exit
on breach, used as a CI gate).

Instrumented layers: ``faas/engine.py`` (per-dispatch invocation spans,
cold-start/retry/hedge instants, utilization gauges),
``faas/engine_vec.py`` (wave-granularity spans so the vectorized path
stays fast), ``faas/chaos.py`` (fault-injection instants + storm/zombie
burst dumps), ``service/scheduler.py`` (job admit/deliver/preempt,
per-tenant cost attribution), ``service/planner.py`` (plan decisions,
infeasibility dumps), and ``cb/pipeline.py`` (commit spans, cache and
selector hits, CI-width convergence).

Plumbing is a process-global context rather than threaded parameters:
``set_obs(Observability.recording())`` turns the sensors on for every
engine/fleet/pipeline constructed afterwards, ``use_obs(...)`` scopes it
(tests), and the default — no context, or ``Observability.null()`` — is
inert.  Hot loops resolve the context *once per run* into a local
(``tr = obs.tracer if obs.enabled else None``), so the disabled path
costs one attribute read per run plus one ``is not None`` branch per
dispatch (the ≤5% N=10^5 gate in benchmarks/engine_bench.py measures
exactly this).

The hard invariant: instrumentation only reads values the simulation
already computed.  It never draws RNG, never reorders event delivery —
all golden digests replay bit-for-bit with recording enabled
(tests/test_chaos_identity.py, tests/test_service_scheduler.py).
"""
from __future__ import annotations

import contextlib
from typing import Optional

from repro_torch.obs.detectors import (DetectorBank, EWMAZScore, RateSpike,
                                 StaticThreshold, StuckGauge)
from repro_torch.obs.incidents import (IncidentLog, incident_scope,
                                 render_incidents)
from repro_torch.obs.metrics import MetricsRegistry, QuantileSketch, WindowedRing
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.slo import SLOMonitor, SLOSpec, default_slos, load_slos
from repro_torch.obs.trace import (NullTracer, RecordingTracer, events_to_chrome,
                             validate_chrome_trace, write_chrome_trace)


class Observability:
    """Bundle of tracer + metrics + recorder (+ monitor) handed around
    as one unit."""

    def __init__(self, tracer=None, metrics=None, recorder=None,
                 monitor=None):
        self.tracer = tracer if tracer is not None else NullTracer()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.recorder = recorder
        self.monitor = monitor
        self.enabled = bool(self.tracer.enabled)

    @classmethod
    def null(cls) -> "Observability":
        """Inert bundle: all emission sites resolve to no-ops.  Exists so
        the overhead benchmark can price the guard branches themselves."""
        return cls(NullTracer(), MetricsRegistry(), None)

    @classmethod
    def recording(cls, *, ring_capacity: int = 2048,
                  max_dumps: int = 8) -> "Observability":
        rec = FlightRecorder(capacity=ring_capacity, max_dumps=max_dumps)
        return cls(RecordingTracer(recorder=rec), MetricsRegistry(), rec)

    @classmethod
    def monitoring(cls, slos=None, *, ring_capacity: int = 2048,
                   max_dumps: int = 8, window_s: float = 60.0,
                   detectors: bool = True) -> "Observability":
        """Recording plus the active layer: SLO evaluators and streaming
        anomaly detectors watch the metric stream as it is produced.
        ``slos=None`` arms the stock objectives (slo.default_slos)."""
        rec = FlightRecorder(capacity=ring_capacity, max_dumps=max_dumps)
        metrics = MetricsRegistry()
        mon = SLOMonitor(slos, metrics=metrics, window_s=window_s,
                         detectors=detectors)
        return cls(RecordingTracer(recorder=rec), metrics, rec, mon)

    # ------------------------------------------------------------ export
    def export_trace(self, path: str) -> None:
        write_chrome_trace(self.tracer.to_chrome_trace(), path)

    def export_metrics(self, path: str) -> None:
        self.metrics.to_json(path)

    def export_dumps(self, path: str) -> None:
        import json
        snap = (self.recorder.snapshot() if self.recorder is not None
                else {"schema": 1, "dumps": []})
        with open(path, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)

    # --------------------------------------------------------- incidents
    def incidents(self, **kwargs) -> list:
        """Cluster the monitor's alerts with trace/dump evidence into
        incident records (empty without a monitor)."""
        if self.monitor is None:
            return []
        dumps = self.recorder.dumps if self.recorder is not None else []
        return IncidentLog(**kwargs).build(
            self.monitor.alerts, self.monitor.anomalies,
            self.tracer.events(), dumps)

    def health(self, **kwargs) -> dict:
        """Machine-readable health verdict (repro_torch.obs.watch schema)."""
        mon = self.monitor
        incidents = self.incidents(**kwargs)
        return {"schema": 1,
                "verdict": mon.verdict() if mon is not None else "healthy",
                "slos": ([s.to_dict() for s in mon.specs]
                         if mon is not None else []),
                "alerts": list(mon.alerts) if mon is not None else [],
                "anomalies": (list(mon.anomalies)
                              if mon is not None else []),
                "active": (mon.active_alerts()
                           if mon is not None else []),
                "incidents": incidents}


_OBS: Optional[Observability] = None


def get_obs() -> Optional[Observability]:
    """The process-wide observability context (None = fully off)."""
    return _OBS


def set_obs(obs: Optional[Observability]) -> Optional[Observability]:
    """Install the context; returns the previous one."""
    global _OBS
    prev, _OBS = _OBS, obs
    return prev


@contextlib.contextmanager
def use_obs(obs: Optional[Observability]):
    """Scoped install (tests): restores the previous context on exit."""
    prev = set_obs(obs)
    try:
        yield obs
    finally:
        set_obs(prev)


__all__ = [
    "DetectorBank", "EWMAZScore", "FlightRecorder", "IncidentLog",
    "MetricsRegistry", "NullTracer", "Observability", "QuantileSketch",
    "RateSpike", "RecordingTracer", "SLOMonitor", "SLOSpec",
    "StaticThreshold", "StuckGauge", "WindowedRing", "default_slos",
    "events_to_chrome", "get_obs", "incident_scope", "load_slos",
    "render_incidents",
    "set_obs", "use_obs", "validate_chrome_trace", "write_chrome_trace",
]
