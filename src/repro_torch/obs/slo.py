"""Declarative SLOs compiled to incremental virtual-time evaluators.

An ``SLOSpec`` names an objective over the live telemetry stream::

    SLOSpec(name="lambda-errors", kind="error_rate", threshold=0.02,
            window_s=60.0, short_windows=1, long_windows=10,
            burn_factor=4.0, labels=(("provider", "lambda"),))

``SLOMonitor`` compiles specs into evaluators, owns the windowed engine
feeds (latency / cold / error / timeout rings per provider, plus the
default anomaly-detector banks from detectors.py), ingests per-job
progress events from the service scheduler, and appends alert records —
all driven by the *virtual* clock, so a seeded run produces the same
alerts bit-for-bit every time.

Rate SLOs use multi-window burn-rate alerting (the Google SRE shape): a
page needs both the short window (fast, noisy) and the long window
(slow, confident) burning above ``burn_factor`` x the error budget, and
clears once the short window falls back under budget.  That single rule
kills both failure modes of static thresholds: one bad window cannot
page, and a sustained incident cannot hide behind a long average.

Kinds
=====

- ``deadline``        jobs must deliver within their deadline; warns at
                      ``warn_frac`` of the budget, breaches when late
- ``budget_burn``     per-job cost burn vs the spend rate that would
                      exactly exhaust the budget at the deadline
- ``ci_convergence``  CI half-widths must reach ``threshold`` %% by
                      ``deadline_s`` virtual seconds
- ``cold_start_rate`` windowed cold-start fraction, burn-rate alerting
- ``error_rate``      windowed failure fraction, burn-rate alerting
- ``timeout_rate``    windowed timeout fraction, burn-rate alerting
- ``p99_latency``     fleet p99 (merged sketches) vs ``threshold``
                      seconds, evaluated at drain points

The monitor only *reads* simulation values — same zero-perturbation
contract as the tracer, so every golden digest replays with monitoring
attached.
"""
from __future__ import annotations

import json
import math
from collections import deque
from dataclasses import dataclass, fields
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.detectors import (DetectorBank, EWMAZScore, RateSpike,
                                 StuckGauge)
from repro_torch.obs.metrics import MetricsRegistry, QuantileSketch

KINDS = ("deadline", "budget_burn", "ci_convergence", "cold_start_rate",
         "error_rate", "timeout_rate", "p99_latency")

_RATE_SERIES = {"cold_start_rate": "engine.win.cold",
                "error_rate": "engine.win.err",
                "timeout_rate": "engine.win.timeout"}


@dataclass(frozen=True)
class SLOSpec:
    """One declarative objective.  ``labels`` is a selector: a series or
    job matches when its labels are a superset (empty = match all)."""

    name: str
    kind: str
    threshold: float = 0.0
    deadline_s: float = 0.0
    window_s: float = 60.0
    short_windows: int = 1
    long_windows: int = 10
    burn_factor: float = 4.0
    warn_frac: float = 0.8
    severity: str = "page"
    labels: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.window_s <= 0:
            raise ValueError("window_s must be positive")
        if self.short_windows > self.long_windows:
            raise ValueError("short_windows must be <= long_windows")

    def label_dict(self) -> dict:
        return dict(self.labels)

    def matches(self, labels: dict) -> bool:
        return all(labels.get(k) == v for k, v in self.labels)

    def to_dict(self) -> dict:
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        d["labels"] = dict(self.labels)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SLOSpec":
        d = dict(d)
        labels = d.pop("labels", {})
        if isinstance(labels, dict):
            labels = tuple(sorted((k, str(v)) for k, v in labels.items()))
        else:
            labels = tuple((k, str(v)) for k, v in labels)
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown SLOSpec fields: {sorted(unknown)}")
        return cls(labels=labels, **d)


def load_slos(path: str) -> List[SLOSpec]:
    """Parse an SLO spec file: either a JSON array of spec objects or
    ``{"slos": [...]}``."""
    with open(path) as f:
        doc = json.load(f)
    rows = doc.get("slos", doc) if isinstance(doc, dict) else doc
    if not isinstance(rows, list):
        raise ValueError(f"{path}: expected a JSON array or "
                         "an object with a 'slos' array")
    return [SLOSpec.from_dict(r) for r in rows]


def default_slos(*, window_s: float = 60.0) -> List[SLOSpec]:
    """The stock objectives the watch CLI and service monitoring use
    when no spec file is given.  Thresholds are sized so the calm seeded
    scenarios stay silent (obs_bench's zero-false-alert gate)."""
    return [
        SLOSpec(name="job-deadline", kind="deadline", warn_frac=0.85),
        SLOSpec(name="tenant-budget-burn", kind="budget_burn",
                window_s=window_s, short_windows=2, long_windows=10,
                burn_factor=4.0, severity="warn"),
        SLOSpec(name="ci-convergence", kind="ci_convergence",
                threshold=5.0, deadline_s=900.0, severity="warn"),
        SLOSpec(name="error-rate", kind="error_rate", threshold=0.02,
                window_s=window_s, short_windows=1, long_windows=8,
                burn_factor=4.0),
        SLOSpec(name="timeout-rate", kind="timeout_rate", threshold=0.02,
                window_s=window_s, short_windows=1, long_windows=8,
                burn_factor=4.0),
        SLOSpec(name="cold-start-rate", kind="cold_start_rate",
                threshold=0.25, window_s=window_s, short_windows=2,
                long_windows=10, burn_factor=2.0, severity="warn"),
        SLOSpec(name="p99-latency", kind="p99_latency", threshold=30.0,
                severity="warn"),
    ]


# --------------------------------------------------------------------------
# evaluators


class _Evaluator:
    def __init__(self, spec: SLOSpec):
        self.spec = spec

    def job_event(self, ev: dict) -> List[dict]:
        return []

    def evaluate(self, now: float, mon: "SLOMonitor") -> List[dict]:
        return []

    def _alert(self, state: str, t: float, message: str,
               labels: Optional[dict] = None, **extra) -> dict:
        a = {"type": "slo", "slo": self.spec.name, "kind": self.spec.kind,
             "severity": ("page" if state == "breach"
                          else self.spec.severity),
             "state": state, "t": float(t), "message": message,
             "labels": dict(labels or {})}
        a.update(extra)
        return a


class _DeadlineEval(_Evaluator):
    """Per-job delivery deadline: warn at ``warn_frac`` of the budget,
    breach on late delivery or on the clock passing the deadline with
    the job still in flight."""

    def __init__(self, spec: SLOSpec):
        super().__init__(spec)
        # job -> [t_submit, deadline_s, tenant, warned, breached]
        self._jobs: Dict[str, list] = {}

    def _deadline(self, ev: dict) -> float:
        if self.spec.deadline_s > 0:
            return self.spec.deadline_s
        return float(ev.get("deadline_s") or 0.0)

    def job_event(self, ev: dict) -> List[dict]:
        kind = ev["kind"]
        labels = {"tenant": ev.get("tenant", "-"), "job": ev.get("job", "-")}
        if not self.spec.matches(labels):
            return []
        job = ev.get("job", "-")
        if kind == "submitted":
            dl = self._deadline(ev)
            if dl > 0:
                self._jobs[job] = [float(ev["t"]), dl,
                                   ev.get("tenant", "-"), False, False]
            return []
        st = self._jobs.get(job)
        if st is None:
            return []
        if kind == "deadline_renegotiated":
            # the re-plan controller agreed new terms with the tenant:
            # the objective tracks the renegotiated horizon (and re-arms
            # the at-risk warning for it) instead of hard-breaching the
            # terms that no longer exist
            new_dl = float(ev.get("deadline_s") or 0.0)
            if new_dl > 0:
                st[1] = new_dl
                st[3] = False
            return []
        if kind == "delivered":
            del self._jobs[job]
            elapsed = float(ev["t"]) - st[0]
            if elapsed > st[1] and not st[4]:
                return [self._alert(
                    "breach", ev["t"],
                    f"job {job} (tenant {st[2]}) delivered at "
                    f"{elapsed:.0f}s, {elapsed - st[1]:.0f}s past its "
                    f"{st[1]:.0f}s deadline", labels,
                    elapsed_s=elapsed, deadline_s=st[1])]
            return []
        if kind == "preempted":
            del self._jobs[job]
        return []

    def evaluate(self, now: float, mon: "SLOMonitor") -> List[dict]:
        out = []
        for job, st in sorted(self._jobs.items()):
            t0, dl, tenant, warned, breached = st
            labels = {"tenant": tenant, "job": job}
            if not breached and now > t0 + dl:
                st[4] = True
                out.append(self._alert(
                    "breach", t0 + dl,
                    f"job {job} (tenant {tenant}) passed its {dl:.0f}s "
                    f"deadline undelivered", labels, deadline_s=dl))
            elif not warned and now >= t0 + self.spec.warn_frac * dl:
                st[3] = True
                frac = (now - t0) / dl
                out.append(self._alert(
                    "fire", now,
                    f"job {job} (tenant {tenant}) deadline at risk: "
                    f"{frac * 100:.0f}% of its {dl:.0f}s budget elapsed, "
                    f"not delivered", labels, elapsed_frac=frac))
        return out


class _BudgetBurnEval(_Evaluator):
    """Cost burn vs the rate that would exactly exhaust the budget at
    the deadline.  Multi-window: both the short and long trailing
    windows must burn above ``burn_factor`` x ideal to fire."""

    def __init__(self, spec: SLOSpec):
        super().__init__(spec)
        # job -> {"samples": deque[(t, frac)], "horizon": s, "tenant": t,
        #         "alerting": bool, "breached": bool}
        self._jobs: Dict[str, dict] = {}

    def job_event(self, ev: dict) -> List[dict]:
        kind = ev["kind"]
        labels = {"tenant": ev.get("tenant", "-"), "job": ev.get("job", "-")}
        if not self.spec.matches(labels):
            return []
        job = ev.get("job", "-")
        if kind == "submitted":
            horizon = float(ev.get("deadline_s") or 0.0)
            if float(ev.get("budget_usd") or 0.0) > 0 and horizon > 0:
                self._jobs[job] = {
                    "samples": deque(), "horizon": horizon,
                    "tenant": ev.get("tenant", "-"),
                    "alerting": False, "breached": False}
            return []
        st = self._jobs.get(job)
        if st is None:
            return []
        if kind in ("delivered", "preempted"):
            del self._jobs[job]
            return []
        if kind != "budget":
            return []
        t, frac = float(ev["t"]), float(ev["frac"])
        keep = self.spec.long_windows * self.spec.window_s
        samples = st["samples"]
        samples.append((t, frac))
        while len(samples) > 2 and samples[1][0] <= t - keep:
            samples.popleft()
        out = []
        if frac >= 1.0 and not st["breached"]:
            st["breached"] = True
            out.append(self._alert(
                "breach", t,
                f"job {job} (tenant {st['tenant']}) budget exhausted "
                f"({frac * 100:.0f}% burned)", labels, burn_frac=frac))

        def burn(window_s: float) -> float:
            t0 = t - window_s
            prev = samples[0]
            for s in samples:
                if s[0] <= t0:
                    prev = s
                else:
                    break
            dt = t - prev[0]
            if dt <= 0:
                return 0.0
            # ideal spend rate is 1.0 budget per horizon seconds
            return (frac - prev[1]) / (dt / st["horizon"])

        b_short = burn(self.spec.short_windows * self.spec.window_s)
        b_long = burn(self.spec.long_windows * self.spec.window_s)
        if (not st["alerting"]
                and min(b_short, b_long) >= self.spec.burn_factor):
            st["alerting"] = True
            out.append(self._alert(
                "fire", t,
                f"job {job} (tenant {st['tenant']}) burning budget at "
                f"{b_short:.1f}x the sustainable rate "
                f"({frac * 100:.0f}% spent)", labels,
                burn_short=b_short, burn_long=b_long, burn_frac=frac))
        elif st["alerting"] and b_short < 1.0:
            st["alerting"] = False
            out.append(self._alert(
                "clear", t,
                f"job {job} (tenant {st['tenant']}) budget burn back "
                f"under the sustainable rate", labels,
                burn_short=b_short, burn_frac=frac))
        return out


class _CIConvergenceEval(_Evaluator):
    """CI half-widths must reach ``threshold`` %% by ``deadline_s``."""

    def __init__(self, spec: SLOSpec):
        super().__init__(spec)
        # benchmark -> [width, t, warned, breached]
        self._width: Dict[str, list] = {}

    def job_event(self, ev: dict) -> List[dict]:
        if ev["kind"] != "ci_width":
            return []
        labels = {"benchmark": ev.get("benchmark", "-"),
                  "provider": ev.get("provider", "-")}
        if not self.spec.matches(labels):
            return []
        b = ev.get("benchmark", "-")
        st = self._width.get(b)
        if st is None:
            st = self._width[b] = [math.inf, 0.0, False, False]
        st[0] = float(ev["width_pct"])
        st[1] = float(ev["t"])
        return []

    def evaluate(self, now: float, mon: "SLOMonitor") -> List[dict]:
        if self.spec.deadline_s <= 0:
            return []
        out = []
        for b, st in sorted(self._width.items()):
            width, _, warned, breached = st
            labels = {"benchmark": b}
            if width <= self.spec.threshold:
                continue
            if not breached and now >= self.spec.deadline_s:
                st[3] = True
                out.append(self._alert(
                    "breach", self.spec.deadline_s,
                    f"benchmark {b} CI width {width:.1f}% still above "
                    f"{self.spec.threshold:.1f}% at the "
                    f"{self.spec.deadline_s:.0f}s convergence deadline",
                    labels, width_pct=width))
            elif (not warned
                  and now >= self.spec.warn_frac * self.spec.deadline_s):
                st[2] = True
                out.append(self._alert(
                    "fire", now,
                    f"benchmark {b} CI width {width:.1f}% not yet at "
                    f"{self.spec.threshold:.1f}% with "
                    f"{self.spec.deadline_s - now:.0f}s to the "
                    f"convergence deadline", labels, width_pct=width))
        return out


class _RateEval(_Evaluator):
    """Multi-window burn-rate over a windowed 0/1 ring (cold / err /
    timeout fraction of dispatches).  Walks closed windows exactly once
    per series, so drain cadence cannot change what fires."""

    def __init__(self, spec: SLOSpec):
        super().__init__(spec)
        self.series = _RATE_SERIES[spec.kind]
        # ring key -> {"frontier": int|None, "recent": deque[(count,sum)],
        #              "alerting": bool}
        self._state: Dict[Tuple, dict] = {}

    def evaluate(self, now: float, mon: "SLOMonitor") -> List[dict]:
        out = []
        thr = max(self.spec.threshold, 1e-12)
        for labels, ring in mon.metrics.window_series(self.series):
            if not self.spec.matches(labels):
                continue
            key = tuple(sorted(labels.items()))
            st = self._state.get(key)
            if st is None:
                st = self._state[key] = {
                    "frontier": None,
                    "recent": deque(maxlen=self.spec.long_windows),
                    "alerting": False}
            closed = int(math.floor(now / ring.window_s))
            indices = ring.window_indices()
            if st["frontier"] is None:
                if not indices:
                    continue
                st["frontier"] = indices[0]
            start = max(st["frontier"], closed - ring.capacity)
            for w in range(start, closed):
                agg = ring.aggregate(w)
                if agg is None or agg[0] == 0:
                    continue      # idle window: no traffic, no verdict
                st["recent"].append((agg[0], agg[1]))
                rec = st["recent"]
                s = min(self.spec.short_windows, len(rec))
                shorts = list(rec)[-s:]
                n_s = sum(c for c, _ in shorts)
                n_l = sum(c for c, _ in rec)
                rate_s = sum(v for _, v in shorts) / n_s if n_s else 0.0
                rate_l = sum(v for _, v in rec) / n_l if n_l else 0.0
                burn_s, burn_l = rate_s / thr, rate_l / thr
                t_end = (w + 1) * ring.window_s
                if (not st["alerting"] and len(rec) >= s
                        and min(burn_s, burn_l) >= self.spec.burn_factor):
                    st["alerting"] = True
                    out.append(self._alert(
                        "fire", t_end,
                        f"{self.spec.kind} {rate_s * 100:.1f}% over "
                        f"[{w * ring.window_s:.0f}s,{t_end:.0f}s) — "
                        f"{burn_s:.1f}x the {thr * 100:.2f}% budget "
                        f"(long-window {burn_l:.1f}x)"
                        + (f" on {labels.get('provider')}"
                           if labels.get("provider") else ""),
                        labels, rate=rate_s, burn_short=burn_s,
                        burn_long=burn_l, window=w))
                elif st["alerting"] and burn_s < 1.0:
                    st["alerting"] = False
                    out.append(self._alert(
                        "clear", t_end,
                        f"{self.spec.kind} back under budget "
                        f"({rate_s * 100:.2f}%)", labels,
                        rate=rate_s, window=w))
            st["frontier"] = max(st["frontier"], closed)
        return out


class _P99Eval(_Evaluator):
    """Fleet p99 latency vs threshold: merges every matching latency
    sketch (true fleet percentile, not a max-of-maxes) at each drain."""

    def __init__(self, spec: SLOSpec):
        super().__init__(spec)
        self._alerting = False

    def evaluate(self, now: float, mon: "SLOMonitor") -> List[dict]:
        merged = QuantileSketch()
        for labels, sk in mon.metrics.histogram_series("engine.latency_s"):
            if self.spec.matches(labels):
                merged.merge(sk)
        if not merged.count:
            return []
        p99 = merged.quantile(0.99)
        if not self._alerting and p99 > self.spec.threshold:
            self._alerting = True
            return [self._alert(
                "fire", now,
                f"fleet p99 latency {p99:.2f}s above the "
                f"{self.spec.threshold:.2f}s objective "
                f"({merged.count} invocations)", self.spec.label_dict(),
                p99_s=p99)]
        if self._alerting and p99 <= 0.95 * self.spec.threshold:
            self._alerting = False
            return [self._alert(
                "clear", now,
                f"fleet p99 latency {p99:.2f}s back under the "
                f"{self.spec.threshold:.2f}s objective",
                self.spec.label_dict(), p99_s=p99)]
        return []


_EVALS = {"deadline": _DeadlineEval, "budget_burn": _BudgetBurnEval,
          "ci_convergence": _CIConvergenceEval, "cold_start_rate": _RateEval,
          "error_rate": _RateEval, "timeout_rate": _RateEval,
          "p99_latency": _P99Eval}


# --------------------------------------------------------------------------
# engine feeds + monitor


class EngineFeed:
    """Per-provider windowed feed the engines resolve once per run.

    ``dispatch`` is the scalar per-event path; ``dispatch_wave`` ingests
    whole vectorized waves with the bulk-observe path (bit-for-bit equal
    to the loop, see WindowedRing.observe_many)."""

    __slots__ = ("lat", "cold", "err", "timeout")

    def __init__(self, metrics: MetricsRegistry, provider: str,
                 window_s: float):
        self.lat = metrics.window("engine.win.latency", window_s,
                                  provider=provider)
        self.cold = metrics.window("engine.win.cold", window_s,
                                   provider=provider)
        self.err = metrics.window("engine.win.err", window_s,
                                  provider=provider)
        self.timeout = metrics.window("engine.win.timeout", window_s,
                                      provider=provider)

    def dispatch(self, t: float, dur: float, cold: bool, ok: bool,
                 timed_out: bool) -> None:
        self.lat.observe(t, dur)
        self.cold.observe(t, 1.0 if cold else 0.0)
        self.err.observe(t, 0.0 if ok else 1.0)
        self.timeout.observe(t, 1.0 if timed_out else 0.0)

    def dispatch_wave(self, ts, durs, cold_mask, ok_mask,
                      timed_mask) -> None:
        import numpy as np
        self.lat.observe_many(ts, durs)
        self.cold.observe_many(ts, np.asarray(cold_mask, float))
        self.err.observe_many(ts, 1.0 - np.asarray(ok_mask, float))
        self.timeout.observe_many(ts, np.asarray(timed_mask, float))


def _default_banks(metrics: MetricsRegistry, provider: str,
                   feed: EngineFeed, window_s: float) -> List[DetectorBank]:
    labels = {"provider": provider}
    return [
        DetectorBank("engine.win.latency", feed.lat,
                     [EWMAZScore(value="mean", alpha=0.3, z_on=6.0,
                                 z_off=2.0, warmup=6),
                      StuckGauge(value="mean", stuck_windows=8,
                                 min_count=3)], labels),
        DetectorBank("engine.win.err", feed.err,
                     [RateSpike(value="sum", ratio=4.0, clear_ratio=1.5,
                                min_count=8, baseline_windows=8,
                                warmup=3)], labels),
        DetectorBank("engine.win.timeout", feed.timeout,
                     [RateSpike(value="sum", ratio=4.0, clear_ratio=1.5,
                                min_count=8, baseline_windows=8,
                                warmup=3)], labels),
        DetectorBank("engine.win.cold", feed.cold,
                     [EWMAZScore(value="mean", alpha=0.3, z_on=6.0,
                                 z_off=2.0, warmup=6)], labels),
    ]


class SLOMonitor:
    """Compiled SLO evaluators + anomaly-detector banks over the live
    metric stream.  One instance per Observability bundle."""

    def __init__(self, specs: Optional[List[SLOSpec]] = None, *,
                 metrics: Optional[MetricsRegistry] = None,
                 window_s: float = 60.0, detectors: bool = True,
                 bank_factory=None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.specs = list(specs) if specs is not None else default_slos(
            window_s=window_s)
        self.window_s = float(window_s)
        self.with_detectors = detectors
        # pluggable detector wiring: benchmarks/obs_bench.py swaps in
        # naive static-threshold banks to quantify what the adaptive
        # baselines buy; signature (metrics, provider, feed, window_s)
        self._bank_factory = (bank_factory if bank_factory is not None
                              else _default_banks)
        self._evals = [_EVALS[s.kind](s) for s in self.specs]
        self._feeds: Dict[str, EngineFeed] = {}
        self._banks: List[DetectorBank] = []
        self.alerts: List[dict] = []      # chronological slo alerts
        self.anomalies: List[dict] = []   # chronological detector events
        self._last_eval = 0.0

    # ----------------------------------------------------------- feeding
    def engine_feed(self, provider: str) -> EngineFeed:
        """Resolve (once per run) the windowed feed for a provider
        fleet; first resolution also arms the default detector banks."""
        feed = self._feeds.get(provider)
        if feed is None:
            feed = self._feeds[provider] = EngineFeed(
                self.metrics, provider, self.window_s)
            if self.with_detectors:
                self._banks.extend(self._bank_factory(
                    self.metrics, provider, feed, self.window_s))
        return feed

    def job_event(self, kind: str, t: float, **fields) -> None:
        """Per-job progress from the service scheduler / cb pipeline:
        submitted / budget / ci_width / delivered / preempted."""
        ev = {"kind": kind, "t": float(t)}
        ev.update(fields)
        for e in self._evals:
            self.alerts.extend(e.job_event(ev))

    # -------------------------------------------------------- evaluation
    def evaluate(self, now: float) -> List[dict]:
        """Drain detector banks and run every evaluator up to virtual
        time ``now``; returns (and records) the new alert/anomaly rows.
        Idempotent for a given clock value."""
        now = max(float(now), self._last_eval)
        self._last_eval = now
        fresh: List[dict] = []
        for bank in self._banks:
            for ev in bank.drain(now):
                row = {"type": "anomaly", "severity": "warn"}
                row.update(ev)
                self.anomalies.append(row)
                fresh.append(row)
        for e in self._evals:
            for a in e.evaluate(now, self):
                self.alerts.append(a)
                fresh.append(a)
        return fresh

    # --------------------------------------------------------------- feed
    def alert_feed(self, cursor: Tuple[int, int] = (0, 0)
                   ) -> Tuple[List[dict], Tuple[int, int]]:
        """Controller-consumable feed: the alert + anomaly rows recorded
        since ``cursor``, merged into one chronological stream, plus the
        new cursor.  Rows are the monitor's own records (not copies) —
        consumers must treat them as read-only.  The cursor is a plain
        ``(n_alerts_seen, n_anomalies_seen)`` pair, so feeding is
        idempotent and independent of *when* the consumer polls: any
        polling cadence yields the same cumulative stream (the property
        the online re-planner's determinism rests on)."""
        a0, n0 = cursor
        fresh = self.alerts[a0:] + self.anomalies[n0:]
        fresh.sort(key=lambda r: (r["t"],
                                  r.get("slo") or r.get("detector") or "",
                                  r.get("state", "")))
        return fresh, (len(self.alerts), len(self.anomalies))

    # ----------------------------------------------------------- verdict
    def breaches(self) -> List[dict]:
        return [a for a in self.alerts if a["state"] == "breach"]

    def active_alerts(self) -> List[dict]:
        """Fire events not yet cleared, keyed by (slo/detector, labels)."""
        open_by_key: Dict[tuple, dict] = {}
        for a in self.alerts + self.anomalies:
            key = (a.get("slo") or a.get("detector"),
                   tuple(sorted(a.get("labels", {}).items())),
                   a.get("series"))
            if a["state"] == "fire":
                open_by_key[key] = a
            elif a["state"] == "clear":
                open_by_key.pop(key, None)
        return sorted(open_by_key.values(), key=lambda a: a["t"])

    def verdict(self) -> str:
        """``healthy`` | ``warn`` | ``breach`` — the watch CLI's exit
        status maps straight onto this."""
        if self.breaches():
            return "breach"
        if any(a["severity"] == "page" for a in self.active_alerts()):
            return "breach"
        if self.alerts or self.anomalies:
            return "warn"
        return "healthy"

    def snapshot(self) -> dict:
        return {"schema": 1,
                "window_s": self.window_s,
                "slos": [s.to_dict() for s in self.specs],
                "verdict": self.verdict(),
                "alerts": list(self.alerts),
                "anomalies": list(self.anomalies),
                "active": self.active_alerts()}


__all__ = ["KINDS", "EngineFeed", "SLOMonitor", "SLOSpec", "default_slos",
           "load_slos"]
