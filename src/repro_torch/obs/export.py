"""Trace exporters: Chrome trace-event JSON + terminal time-in-state.

``chrome_trace``/``write_chrome_trace`` emit the Chrome trace-event
format (the ``{"traceEvents": [...]}`` object form) that
https://ui.perfetto.dev loads directly: one process row per host
(``pid`` = host rank), one thread lane per ring (``tid``), span events
as ``ph="X"`` with µs timestamps, counters as ``ph="C"``. Lane names
and ordering travel as ``"M"`` metadata events.

``time_in_state`` turns each lane's spans into per-state self-time:
spans are sorted by start (ties: longer first) and walked with an
interval stack so a nested span's duration is billed to ITS category
and subtracted from the parent's — a worker's "task" span containing a
blocking "sweep" span yields eval = task − sweep. Categories map to
the summary states: task→eval, sweep/flush→sweep, idle→idle,
steal→steal, everything else→other. ``summary_table`` renders that per
worker with a coverage column against ``wall_s``.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.tracer import TraceEvent, Tracer

__all__ = [
    "chrome_trace", "write_chrome_trace", "time_in_state",
    "summary_table", "check_nesting", "STATE_OF_CAT",
]

# span category -> summary state
STATE_OF_CAT = {
    "task": "eval",
    "level": "eval",
    "sweep": "sweep",
    "flush": "sweep",
    "net": "sweep",
    "arena": "sweep",
    "idle": "idle",
    "steal": "steal",
}
STATES = ("eval", "sweep", "idle", "steal", "other")


def chrome_trace(tracer: Tracer) -> Dict[str, Any]:
    """Build the Chrome trace-event JSON object for ``tracer``."""
    evs = tracer.events()
    out: List[Dict[str, Any]] = []
    seen_pids = set()
    for pid, tid, name in tracer.lanes():
        if pid not in seen_pids:
            seen_pids.add(pid)
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": f"host-{pid}"}})
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": name}})
    for i, (pid, tid, _name) in enumerate(tracer.lanes()):
        out.append({"ph": "M", "name": "thread_sort_index", "pid": pid,
                    "tid": tid, "args": {"sort_index": i}})
    for ev in evs:
        rec: Dict[str, Any] = {
            "ph": ev.ph, "name": ev.name, "cat": ev.cat,
            "pid": ev.pid, "tid": ev.tid,
            "ts": round(ev.ts * 1e6, 3),
        }
        if ev.ph == "X":
            rec["dur"] = round(ev.dur * 1e6, 3)
        if ev.args is not None:
            rec["args"] = ev.args
        elif ev.ph == "C":
            rec["args"] = {}
        out.append(rec)
    doc: Dict[str, Any] = {"traceEvents": out, "displayTimeUnit": "ms"}
    dropped = tracer.dropped()
    if dropped:
        doc["otherData"] = {"dropped_events": dropped}
    return doc


def write_chrome_trace(tracer: Tracer, path: str) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer), f)
    return path


def _lane_spans(events: Sequence[TraceEvent]):
    lanes: Dict[Tuple[int, int], Tuple[str, List[TraceEvent]]] = {}
    for ev in events:
        key = (ev.pid, ev.tid)
        if key not in lanes:
            lanes[key] = (ev.lane, [])
        if ev.ph == "X":
            lanes[key][1].append(ev)
    return lanes


def check_nesting(events: Sequence[TraceEvent], eps: float = 1e-6) -> List[str]:
    """Well-formedness: per lane, spans either nest or are disjoint.

    Returns a list of violation descriptions (empty = well formed).
    Partial overlap — a span starting inside another and ending after
    it by more than ``eps`` — is the corruption this catches.
    """
    bad: List[str] = []
    for (pid, tid), (lane, spans) in _lane_spans(events).items():
        ordered = sorted(spans, key=lambda e: (e.ts, -e.dur))
        stack: List[TraceEvent] = []
        for ev in ordered:
            while stack and stack[-1].ts + stack[-1].dur <= ev.ts + eps:
                stack.pop()
            if stack:
                parent = stack[-1]
                if ev.ts + ev.dur > parent.ts + parent.dur + eps:
                    bad.append(
                        f"lane {lane} (pid={pid} tid={tid}): span "
                        f"{ev.name}@{ev.ts:.6f}+{ev.dur:.6f} straddles "
                        f"{parent.name}@{parent.ts:.6f}+{parent.dur:.6f}")
            stack.append(ev)
    return bad


def time_in_state(tracer: Tracer) -> Dict[Tuple[int, int], Dict[str, Any]]:
    """Per-lane self-time by state, plus the lane's covered extent.

    Returns ``{(pid, tid): {"lane": name, "eval": s, "sweep": s,
    "idle": s, "steal": s, "other": s, "total": s, "extent": s}}``
    where ``total`` is the sum of the five states (self-time — nested
    spans bill their own category) and ``extent`` is last span end
    minus first span start on that lane.
    """
    out: Dict[Tuple[int, int], Dict[str, Any]] = {}
    for key, (lane, spans) in _lane_spans(tracer.events()).items():
        acc = {s: 0.0 for s in STATES}
        if not spans:
            continue
        ordered = sorted(spans, key=lambda e: (e.ts, -e.dur))
        # stack entries: [end, state, child_time]
        stack: List[List[Any]] = []

        def bill(entry: List[Any]) -> None:
            end, state, child, dur = entry
            acc[state] += max(0.0, dur - child)

        for ev in ordered:
            while stack and stack[-1][0] <= ev.ts + 1e-9:
                bill(stack.pop())
            state = STATE_OF_CAT.get(ev.cat, "other")
            if stack:
                stack[-1][2] += ev.dur
            stack.append([ev.ts + ev.dur, state, 0.0, ev.dur])
        while stack:
            bill(stack.pop())
        first = min(e.ts for e in ordered)
        last = max(e.ts + e.dur for e in ordered)
        row: Dict[str, Any] = {"lane": lane}
        row.update(acc)
        row["total"] = sum(acc.values())
        row["extent"] = last - first
        out[key] = row
    return out


def summary_table(tracer: Tracer, wall_s: Optional[float] = None) -> str:
    """Terminal table: time-in-state per lane, coverage vs ``wall_s``."""
    rows = time_in_state(tracer)
    hdr = f"{'lane':<18} {'pid':>3}  " + "".join(
        f"{s + '_s':>9}" for s in STATES) + f"  {'total_s':>9}"
    if wall_s:
        hdr += f"  {'cover%':>7}"
    lines = [hdr, "-" * len(hdr)]
    for (pid, _tid), row in rows.items():
        line = f"{row['lane']:<18} {pid:>3}  " + "".join(
            f"{row[s]:>9.3f}" for s in STATES) + f"  {row['total']:>9.3f}"
        if wall_s:
            line += f"  {100.0 * row['total'] / wall_s:>6.1f}%"
        lines.append(line)
    if wall_s:
        lines.append(f"{'wall_s':<18} {wall_s:>13.3f}")
    dropped = tracer.dropped()
    if dropped:
        lines.append(f"(ring overflow: {dropped} oldest events dropped)")
    return "\n".join(lines)
