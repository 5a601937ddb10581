"""Incident attribution: join alert firings with co-occurring trace
evidence into structured root-cause records.

An *incident* is a cluster of overlapping alert/anomaly intervals (a
fire and its clear bound the interval; a breach is a point).  For each
cluster the log pulls co-occurring evidence out of the flight-recorder
side of the house — trace instants (``chaos.*`` fault injections,
``engine.*`` cold starts, ``service.*`` admission events) inside the
incident window, and any anomaly dumps the recorder froze there — and
renders a one-line root cause::

    tenant-3 deadline at risk: timeout_rate 12.0% — 8.3x budget in
    [120s,180s); coincides with 41 chaos.timeout instants and a
    timeout_storm_burst dump

Everything is virtual-time and deterministic: same run, same incidents,
bit for bit (the golden incident-log test pins one).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

_SEV_RANK = {"page": 0, "warn": 1}


def _intervals(alerts: List[dict], anomalies: List[dict],
               default_span_s: float) -> List[dict]:
    """Pair fires with their clears into [t_start, t_end] intervals."""
    rows = sorted(alerts + anomalies, key=lambda a: (a["t"], a["state"]))
    open_by_key: Dict[tuple, dict] = {}
    out: List[dict] = []
    for a in rows:
        key = (a.get("slo") or a.get("detector"),
               tuple(sorted(a.get("labels", {}).items())), a.get("series"))
        if a["state"] == "breach":
            out.append({"t_start": a["t"], "t_end": a["t"], "alert": a})
        elif a["state"] == "fire":
            iv = {"t_start": a["t"], "t_end": a["t"] + default_span_s,
                  "alert": a, "cleared": False}
            out.append(iv)
            open_by_key[key] = iv
        elif a["state"] == "clear":
            iv = open_by_key.pop(key, None)
            if iv is not None:
                iv["t_end"] = a["t"]
                iv["cleared"] = True
    return sorted(out, key=lambda iv: (iv["t_start"], iv["t_end"]))


class IncidentLog:
    """Clusters alerts into incidents and attaches trace evidence.

    ``merge_gap_s`` joins intervals whose gap is below it (one burst
    tripping three detectors is one incident, not three);
    ``evidence_slack_s`` widens the evidence window so causes that
    slightly precede detection are still captured.
    """

    def __init__(self, *, merge_gap_s: float = 60.0,
                 evidence_slack_s: float = 90.0,
                 default_span_s: float = 60.0,
                 max_instant_rows: int = 8):
        self.merge_gap_s = merge_gap_s
        self.evidence_slack_s = evidence_slack_s
        self.default_span_s = default_span_s
        self.max_instant_rows = max_instant_rows

    # ------------------------------------------------------------- build
    def build(self, alerts: List[dict], anomalies: List[dict],
              trace_events: Optional[list] = None,
              dumps: Optional[List[dict]] = None) -> List[dict]:
        ivs = _intervals(alerts, anomalies, self.default_span_s)
        if not ivs:
            return []
        clusters: List[List[dict]] = [[ivs[0]]]
        hi = ivs[0]["t_end"]
        for iv in ivs[1:]:
            if iv["t_start"] <= hi + self.merge_gap_s:
                clusters[-1].append(iv)
                hi = max(hi, iv["t_end"])
            else:
                clusters.append([iv])
                hi = iv["t_end"]
        incidents = []
        for i, cl in enumerate(clusters):
            incidents.append(self._incident(i, cl, trace_events or [],
                                            dumps or []))
        return incidents

    def _incident(self, idx: int, cluster: List[dict],
                  trace_events: list, dumps: List[dict]) -> dict:
        t0 = min(iv["t_start"] for iv in cluster)
        t1 = max(iv["t_end"] for iv in cluster)
        rows = [iv["alert"] for iv in cluster]
        severity = min((a.get("severity", "warn") for a in rows),
                       key=lambda s: _SEV_RANK.get(s, 2))
        if any(a["state"] == "breach" for a in rows):
            severity = "page"
        evidence = self._evidence(t0, t1, trace_events, dumps)
        # an incident is *open* while any of its fire intervals is still
        # waiting for its clear — the re-plan controller defers elastic
        # admission exactly while this flag is up
        is_open = any(iv.get("cleared") is False for iv in cluster)
        return {"id": f"inc-{idx + 1:03d}", "open": is_open,
                "t_start": t0, "t_end": t1, "severity": severity,
                "alerts": [a for a in rows if a.get("type") == "slo"],
                "anomalies": [a for a in rows
                              if a.get("type") == "anomaly"],
                "evidence": evidence,
                "root_cause": self._root_cause(t0, t1, rows, evidence)}

    # ---------------------------------------------------------- evidence
    def _evidence(self, t0: float, t1: float, trace_events: list,
                  dumps: List[dict]) -> dict:
        lo = t0 - self.evidence_slack_s
        hi = t1 + self.evidence_slack_s
        # internal event tuples: (ph, name, cat, ts, dur, pid, tid, args)
        counts: Dict[Tuple[str, str], dict] = {}
        for ev in trace_events:
            ph, name, cat, ts = ev[0], ev[1], ev[2], ev[3]
            if ph != "i" or not lo <= ts <= hi:
                continue
            row = counts.get((cat, name))
            if row is None:
                row = counts[(cat, name)] = {
                    "cat": cat, "name": name, "count": 0,
                    "first_t": ts, "last_t": ts}
            row["count"] += 1
            row["last_t"] = ts
        instants = sorted(counts.values(),
                          key=lambda r: (-r["count"], r["cat"], r["name"]))
        dropped = max(0, len(instants) - self.max_instant_rows)
        instants = instants[:self.max_instant_rows]
        drows = [{"reason": d["reason"], "ts": d["ts"],
                  "context": d.get("context", {})}
                 for d in dumps if lo <= d.get("ts", 0.0) <= hi]
        return {"instants": instants, "instants_dropped": dropped,
                "dumps": drows}

    # -------------------------------------------------------- root cause
    def _root_cause(self, t0: float, t1: float, rows: List[dict],
                    evidence: dict) -> str:
        def rank(a):
            breach = 0 if a["state"] == "breach" else 1
            return (breach, _SEV_RANK.get(a.get("severity", "warn"), 2),
                    a["t"])
        primary = min(rows, key=rank)
        msg = primary.get("message") or (
            f"{primary.get('slo') or primary.get('detector')} "
            f"{primary['state']}")
        chaos = [r for r in evidence["instants"]
                 if r["cat"] == "chaos" or r["name"].startswith("chaos.")]
        clauses = []
        if chaos:
            top = chaos[0]
            clauses.append(f"{top['count']} {top['name']} instants in "
                           f"[{top['first_t']:.0f}s,{top['last_t']:.0f}s]")
        reasons = sorted({d["reason"] for d in evidence["dumps"]})
        if reasons:
            n = len(evidence["dumps"])
            clauses.append(
                f"{n} flight-recorder dump{'s' if n != 1 else ''} "
                f"({', '.join(reasons)})")
        extra = len(rows) - 1
        if extra:
            clauses.append(f"{extra} co-firing signal"
                           f"{'s' if extra != 1 else ''}")
        out = msg
        if clauses:
            out += "; coincides with " + " and ".join(clauses)
        return out


def incident_scope(incident: dict) -> Dict[str, List[str]]:
    """Entities an incident's clustered signals name, extracted from
    their labels: ``{"providers": [...], "tenants": [...], "jobs":
    [...]}`` (sorted, possibly empty).  The re-plan controller uses the
    provider scope to steer migrations *away* from the incident."""
    provs, tens, jobs = set(), set(), set()
    for row in incident.get("alerts", []) + incident.get("anomalies", []):
        lb = row.get("labels") or {}
        if lb.get("provider"):
            provs.add(str(lb["provider"]))
        if lb.get("tenant"):
            tens.add(str(lb["tenant"]))
        if lb.get("job"):
            jobs.add(str(lb["job"]))
    return {"providers": sorted(provs), "tenants": sorted(tens),
            "jobs": sorted(jobs)}


def render_incidents(incidents: List[dict]) -> str:
    """Text block for repro_torch.obs.report's incident section."""
    if not incidents:
        return "(no incidents)"
    lines = []
    for inc in incidents:
        lines.append(f"{inc['id']}  [{inc['t_start']:.0f}s, "
                     f"{inc['t_end']:.0f}s]  severity={inc['severity']}  "
                     f"signals={len(inc['alerts']) + len(inc['anomalies'])}")
        lines.append(f"  root cause: {inc['root_cause']}")
        for r in inc["evidence"]["instants"][:3]:
            lines.append(f"  evidence: {r['count']}x {r['cat']}/{r['name']} "
                         f"[{r['first_t']:.0f}s..{r['last_t']:.0f}s]")
        for d in inc["evidence"]["dumps"][:2]:
            lines.append(f"  dump: {d['reason']} @ {d['ts']:.0f}s")
    return "\n".join(lines)


__all__ = ["IncidentLog", "incident_scope", "render_incidents"]
