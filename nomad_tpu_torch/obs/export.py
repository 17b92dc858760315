"""Trace export (a copy of ``nomad_tpu/obs/export.py``): Chrome
``trace_event`` JSON, per-phase percentile breakdowns, and per-eval
span-chain analysis with gap attribution.

The Chrome format is the one ``chrome://tracing`` / Perfetto load
directly: complete events (``"ph": "X"``) with microsecond timestamps,
one row per recording thread. ``python -m nomad_tpu_torch.obs --export``
writes it; ``/v1/traces`` serves the same events inline.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .trace import R_ARGS, R_ID, R_NAME, R_PARENT, R_T0, R_T1, R_THREAD, \
    R_TRACE

# the canonical eval lifecycle, in order. A committed eval's trace must
# contain at least these; raft.* spans are trace-less and attach by time
# overlap.
EVAL_CHAIN = ("eval.queued", "worker.schedule", "plan.submit",
              "plan.verify", "plan.commit")


def chrome_trace(spans: List[tuple]) -> dict:
    """Render span records as a Chrome trace_event JSON object.
    Timestamps are µs relative to the earliest span so the viewer
    opens at t=0."""
    if not spans:
        return {"traceEvents": []}
    base = min(rec[R_T0] for rec in spans)
    events = []
    for rec in spans:
        args = {k: v for k, v in rec[R_ARGS].items()}
        if rec[R_TRACE] is not None:
            args["trace"] = rec[R_TRACE]
        ev = {
            "name": rec[R_NAME],
            "ph": "X",
            "ts": (rec[R_T0] - base) * 1e6,
            "dur": max(0.0, (rec[R_T1] - rec[R_T0]) * 1e6),
            "pid": 1,
            "tid": rec[R_THREAD],
            "args": args,
        }
        if rec[R_PARENT]:
            ev["args"]["parent_span"] = rec[R_PARENT]
        ev["args"]["span"] = rec[R_ID]
        events.append(ev)
    return {"traceEvents": events,
            "displayTimeUnit": "ms"}


def phase_breakdown(spans: List[tuple]) -> Dict[str, dict]:
    """Per-phase duration stats over a span snapshot: count, total,
    p50/p99/max in milliseconds. This is the offline twin of the
    ``nomad.eval.phase.*`` Registry histograms — computed from the
    exported spans so a saved trace file carries its own breakdown."""
    by_name: Dict[str, List[float]] = {}
    for rec in spans:
        d = rec[R_T1] - rec[R_T0]
        if d <= 0:
            continue  # instants
        by_name.setdefault(rec[R_NAME], []).append(d)
    out: Dict[str, dict] = {}
    for name, durs in sorted(by_name.items()):
        durs.sort()
        n = len(durs)
        out[name] = {
            "count": n,
            "total_ms": 1000.0 * sum(durs),
            "p50_ms": 1000.0 * durs[int(0.50 * (n - 1))],
            "p99_ms": 1000.0 * durs[int(round(0.99 * (n - 1)))],
            "max_ms": 1000.0 * durs[-1],
        }
    return out


def spans_for_trace(spans: List[tuple], trace_id: str) -> List[tuple]:
    """Every span covering one eval: spans stamped with its trace id
    plus batch-level spans whose ``traces`` arg lists it."""
    out = []
    for rec in spans:
        if rec[R_TRACE] == trace_id:
            out.append(rec)
        elif trace_id in (rec[R_ARGS].get("traces") or ()):
            out.append(rec)
    out.sort(key=lambda rec: (rec[R_T0], rec[R_T1]))
    return out


def chain_report(spans: List[tuple], trace_id: str,
                 required: tuple = EVAL_CHAIN) -> dict:
    """Analyze one eval's span chain: which lifecycle phases are
    present, whether the chain is contiguous, and — for every hole
    between consecutive top-level spans — which OTHER spans (typically
    trace-less raft work) overlap the hole, attributing the gap.

    Returns {complete, missing, spans: n, coverage, gaps: [...]} where
    each gap is {after, before, ms, attributed: [names]} and
    ``coverage`` is traced-time / wall-time over the eval's window."""
    mine = spans_for_trace(spans, trace_id)
    names = {rec[R_NAME] for rec in mine}
    missing = [n for n in required if n not in names]
    report = {"trace": trace_id, "spans": len(mine),
              "complete": not missing, "missing": missing,
              "gaps": [], "coverage": 0.0}
    if not mine:
        return report
    # top-level chain: the eval's own spans, skipping nested ones
    # (a child starts before its enclosing span ends)
    timeline = [rec for rec in mine if rec[R_T1] > rec[R_T0]]
    if not timeline:
        return report
    t_begin = min(rec[R_T0] for rec in timeline)
    t_end = max(rec[R_T1] for rec in timeline)
    covered = 0.0
    cursor = t_begin
    prev = None
    for rec in timeline:
        if rec[R_T0] > cursor:
            gap0, gap1 = cursor, rec[R_T0]
            attributed = sorted({
                other[R_NAME] for other in spans
                if other[R_T1] > other[R_T0]
                and other[R_T0] < gap1 and other[R_T1] > gap0
                and other is not rec and other not in mine})
            report["gaps"].append({
                "after": prev[R_NAME] if prev else None,
                "before": rec[R_NAME],
                "ms": 1000.0 * (gap1 - gap0),
                "attributed": attributed,
            })
            cursor = rec[R_T0]
        if rec[R_T1] > cursor:
            covered += rec[R_T1] - cursor
            cursor = rec[R_T1]
            prev = rec
    wall = t_end - t_begin
    report["coverage"] = covered / wall if wall > 0 else 1.0
    return report


def render_chain(report: dict) -> str:
    """One-paragraph human rendering of a chain_report (smoke output)."""
    lines = [f"trace {report['trace']}: {report['spans']} span(s), "
             f"coverage {report['coverage']:.0%}, "
             f"{'complete' if report['complete'] else 'MISSING ' + ','.join(report['missing'])}"]
    for g in report["gaps"]:
        who = ", ".join(g["attributed"]) or "untraced"
        lines.append(f"  gap {g['ms']:8.3f}ms {g['after']} -> "
                     f"{g['before']}: {who}")
    return "\n".join(lines)


def write_chrome_trace(path: str, spans: List[tuple],
                       breakdown: Optional[dict] = None) -> None:
    import json

    doc = chrome_trace(spans)
    doc["otherData"] = {"phases": breakdown or phase_breakdown(spans)}
    with open(path, "w") as f:
        json.dump(doc, f)
