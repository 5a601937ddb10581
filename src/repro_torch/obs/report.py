"""Text dashboard over a metrics snapshot (and optionally a trace).

``python -m repro_torch.obs.report metrics.json [--trace trace.json]
[--health health.json] [--top N]`` renders the per-provider engine table
(invocations, cold-start rate, warm-hit rate, slot utilization, and
fleet latency tails — per-series quantile sketches merged by bucket, so
p95/p99 are percentiles of the union, not a max over series) and the
per-tenant cost attribution table (top-N by cost plus a "(+K more)"
roll-up; totals always cover everyone) from a ``MetricsRegistry.to_json``
snapshot.  ``--trace`` additionally validates the Chrome trace_event
document and summarizes it (exits non-zero on schema violations — CI's
obs-smoke job uses that as its gate); ``--health`` renders SLO posture
and the incident log from a ``repro_torch.obs.watch`` health verdict.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple


def _series(snapshot: dict, kind: str, name: str):
    return [r for r in snapshot.get(kind, ()) if r["name"] == name]


def _sum_by(snapshot: dict, name: str, label: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for row in _series(snapshot, "counters", name):
        key = row["labels"].get(label, "-")
        out[key] = out.get(key, 0.0) + row["value"]
    return out


def _fmt_table(headers: List[str], rows: List[List[str]]) -> str:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    def line(cells):
        return "  ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip()
    sep = "  ".join("-" * w for w in widths)
    return "\n".join([line(headers), sep] + [line(r) for r in rows])


def merge_latency_sketches(snapshot: dict,
                           name: str = "engine.latency_s") -> Dict[str, dict]:
    """Fleet-level latency tails per provider: merge each provider's
    per-(provider,benchmark) sketch rows *by bucket* and take quantiles
    of the union — true fleet percentiles, not the max of per-series
    percentiles (which over-reports whenever the slowest benchmark has
    few samples).  Rows without bucket data (legacy snapshots) fall back
    to the old max-of-series aggregation for that provider."""
    from repro_torch.obs.metrics import QuantileSketch
    merged: Dict[str, QuantileSketch] = {}
    fallback: Dict[str, dict] = {}
    for row in _series(snapshot, "histograms", name):
        p = row["labels"].get("provider", "-")
        sk = QuantileSketch.from_row(row)
        if sk is None:
            agg = fallback.setdefault(p, {"count": 0, "p95": 0.0,
                                          "p99": 0.0})
            agg["count"] += row["count"]
            agg["p95"] = max(agg["p95"], row["p95"])
            agg["p99"] = max(agg["p99"], row["p99"])
        elif p in merged:
            merged[p].merge(sk)
        else:
            merged[p] = sk
    out = {p: {"count": sk.count, "p95": sk.quantile(0.95),
               "p99": sk.quantile(0.99)} for p, sk in merged.items()}
    for p, agg in fallback.items():
        cur = out.get(p)
        if cur is None:
            out[p] = agg
        else:
            cur["count"] += agg["count"]
            cur["p95"] = max(cur["p95"], agg["p95"])
            cur["p99"] = max(cur["p99"], agg["p99"])
    return out


def render_provider_table(snapshot: dict) -> str:
    """Engine health per provider fleet."""
    inv = _sum_by(snapshot, "engine.invocations", "provider")
    cold = _sum_by(snapshot, "engine.cold_starts", "provider")
    hists = merge_latency_sketches(snapshot)
    gauges = {(r["labels"].get("provider", "-"), r["name"]): r["value"]
              for r in snapshot.get("gauges", ())
              if r["name"] in ("engine.slot_utilization",
                               "engine.warm_hit_rate")}
    rows = []
    for p in sorted(set(inv) | set(cold) | set(hists)):
        n = inv.get(p, 0.0)
        c = cold.get(p, 0.0)
        h = hists.get(p, {})
        util = gauges.get((p, "engine.slot_utilization"))
        warm = gauges.get((p, "engine.warm_hit_rate"))
        rows.append([
            p, f"{int(n)}", f"{int(c)}",
            f"{(c / n * 100):.1f}%" if n else "-",
            f"{warm * 100:.1f}%" if warm is not None else "-",
            f"{util * 100:.1f}%" if util is not None else "-",
            f"{h.get('p95', 0.0):.3f}" if h else "-",
            f"{h.get('p99', 0.0):.3f}" if h else "-"])
    if not rows:
        return "(no engine metrics)"
    return _fmt_table(["provider", "invocations", "cold", "cold%",
                       "warm-hit", "util", "p95_s", "p99_s"], rows)


def render_tenant_table(snapshot: dict, top: int = 20) -> str:
    """Per-tenant cost attribution: who spent what, against what budget.

    Shows the ``top`` tenants by cost (then billed seconds) plus a
    "(+K more)" roll-up row; TOTAL always covers every tenant."""
    inv = _sum_by(snapshot, "service.invocations", "tenant")
    billed = _sum_by(snapshot, "service.billed_s", "tenant")
    cost = _sum_by(snapshot, "service.cost_usd", "tenant")
    burn = {r["labels"].get("tenant", "-"): r["value"]
            for r in snapshot.get("gauges", ())
            if r["name"] == "service.budget_burn_frac"}
    tenants = sorted(set(inv) | set(billed) | set(cost))
    if not tenants:
        return "(no service metrics)"
    if top > 0 and len(tenants) > top:
        ranked = sorted(tenants,
                        key=lambda t: (-cost.get(t, 0.0),
                                       -billed.get(t, 0.0), t))
        shown = sorted(ranked[:top])
        hidden = ranked[top:]
    else:
        shown, hidden = tenants, []
    rows = []
    for t in shown:
        b = burn.get(t)
        rows.append([t, f"{int(inv.get(t, 0.0))}",
                     f"{billed.get(t, 0.0):.1f}",
                     f"{cost.get(t, 0.0):.4f}",
                     f"{b * 100:.1f}%" if b is not None else "-"])
    if hidden:
        rows.append([f"(+{len(hidden)} more)",
                     f"{int(sum(inv.get(t, 0.0) for t in hidden))}",
                     f"{sum(billed.get(t, 0.0) for t in hidden):.1f}",
                     f"{sum(cost.get(t, 0.0) for t in hidden):.4f}", ""])
    rows.append(["TOTAL", f"{int(sum(inv.values()))}",
                 f"{sum(billed.values()):.1f}",
                 f"{sum(cost.values()):.4f}", ""])
    return _fmt_table(["tenant", "invocations", "billed_s", "cost_usd",
                       "budget_burn"], rows)


def render_cb_table(snapshot: dict) -> str:
    names = ["cb.commits", "cb.benchmarks_selected", "cb.selector_skips",
             "cb.cache_hits"]
    rows = [[n, f"{int(sum(v for _, v in _sum_by(snapshot, n, 'provider').items()))}"]
            for n in names
            if _series(snapshot, "counters", n)]
    # one histogram series exists per (provider, benchmark): collapse the
    # CI-width convergence picture into a spread plus the slowest
    # convergers instead of hundreds of identical-looking rows
    widths = [(row["p50"], row["labels"].get("benchmark", "-"))
              for row in _series(snapshot, "histograms", "cb.ci_width_pct")]
    if widths:
        p50s = sorted(w for w, _ in widths)
        mid = p50s[len(p50s) // 2]
        rows.append(["cb.ci_width_pct series", f"{len(widths)}"])
        rows.append(["cb.ci_width_pct p50 min/med/max",
                     f"{p50s[0]:.2f} / {mid:.2f} / {p50s[-1]:.2f}"])
        worst = sorted(widths, reverse=True)[:3]
        rows.append(["cb.ci_width_pct widest",
                     ", ".join(f"{b} ({w:.1f}%)" for w, b in worst)])
    if not rows:
        return "(no pipeline metrics)"
    return _fmt_table(["pipeline metric", "value"], rows)


def render_slo_section(health: dict) -> str:
    """SLO posture from a health verdict (repro_torch.obs.watch schema)."""
    lines = [f"verdict: {health.get('verdict', '?')}  "
             f"({len(health.get('alerts', []))} alerts, "
             f"{len(health.get('anomalies', []))} anomalies)"]
    slos = health.get("slos", [])
    if slos:
        by_name: Dict[str, List[dict]] = {}
        for a in health.get("alerts", []):
            by_name.setdefault(a.get("slo", "?"), []).append(a)
        rows = []
        for s in slos:
            events = by_name.get(s["name"], [])
            fires = sum(1 for a in events if a["state"] == "fire")
            breaches = sum(1 for a in events if a["state"] == "breach")
            state = ("BREACH" if breaches else
                     "fired" if fires else "ok")
            rows.append([s["name"], s["kind"], state, f"{fires}",
                         f"{breaches}"])
        lines += [_fmt_table(["slo", "kind", "state", "fires",
                              "breaches"], rows)]
    active = health.get("active", [])
    for a in active:
        lines.append(f"  ACTIVE: {a.get('message') or a.get('slo') or a.get('detector')}")
    return "\n".join(lines)


def render_report(snapshot: dict,
                  trace_doc: Optional[dict] = None,
                  health: Optional[dict] = None,
                  top: int = 20) -> str:
    parts = ["== engine (per provider) ==", render_provider_table(snapshot),
             "", "== cost attribution (per tenant) ==",
             render_tenant_table(snapshot, top=top),
             "", "== continuous benchmarking ==", render_cb_table(snapshot)]
    if health is not None:
        from repro_torch.obs.incidents import render_incidents
        parts += ["", "== SLOs ==", render_slo_section(health),
                  "", "== incidents ==",
                  render_incidents(health.get("incidents", []))]
    if trace_doc is not None:
        evs = trace_doc.get("traceEvents", [])
        n_meta = sum(1 for e in evs if e.get("ph") == "M")
        parts += ["", "== trace ==",
                  f"events: {len(evs) - n_meta} (+{n_meta} metadata), "
                  f"lanes: {n_meta}"]
    return "\n".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.report",
        description="Render the observability dashboard from a metrics "
                    "snapshot; optionally validate a Chrome trace.")
    ap.add_argument("metrics", help="metrics snapshot JSON "
                                    "(MetricsRegistry.to_json)")
    ap.add_argument("--trace", default=None,
                    help="Chrome trace_event JSON to validate + summarize")
    ap.add_argument("--health", default=None,
                    help="health verdict JSON (repro_torch.obs.watch schema) to "
                         "render as SLO + incident sections")
    ap.add_argument("--top", type=int, default=20, metavar="N",
                    help="tenant rows to show before rolling the rest "
                         "into one '(+K more)' row (0 = all; default 20)")
    args = ap.parse_args(argv)
    with open(args.metrics) as f:
        snapshot = json.load(f)
    trace_doc = health = None
    code = 0
    if args.trace is not None:
        from repro_torch.obs.trace import validate_chrome_trace
        with open(args.trace) as f:
            trace_doc = json.load(f)
        errors = validate_chrome_trace(trace_doc)
        if errors:
            for e in errors:
                print(f"trace schema violation: {e}", file=sys.stderr)
            code = 1
    if args.health is not None:
        with open(args.health) as f:
            health = json.load(f)
    print(render_report(snapshot, trace_doc, health, top=args.top))
    return code


if __name__ == "__main__":
    raise SystemExit(main())
