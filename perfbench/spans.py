"""Reductions over the spans that the program records inside its host
work, for the per-layer metrics that say what keeps the card waiting
(``perfbench/metrics/<metric>.py``). Each returns None where the run
recorded no such span (a program older than these spans, or a run
without a tracer), and the metric is then left out of the line.

A span counts when it lies inside the window: from the stream's
window-open instant (``Readings.window_ts``) to the window's close,
mapped onto each tracer's timeline through its align instant, so the
queries a stream answers after the window are left out.
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

# nested spans that the dispatcher's flush spends outside its own host
# work: the index copy to stream sync of each kernel launch, and the
# mirror sync before it
FLUSH_CHILDREN = ("launch", "h2d-sync")


def window_spans(rd) -> Iterator[Tuple[int, object]]:
    """``(tracer index, span)`` for the complete spans of the run's
    tracers inside the window."""
    for i, (tracer, host, ts) in enumerate(rd.tracers):
        lo = rd.window_ts
        hi = rd.window[1] - (host - ts) if rd.window[1] else None
        for e in tracer.events():
            if (e.ph == "X" and (lo is None or e.ts >= lo)
                    and (hi is None or e.ts + e.dur <= hi)):
                yield i, e


def ms_per_call(rd, names: Sequence[str]) -> Optional[float]:
    """The spans named ``names``, summed and spread over the window's
    calls (mines, or ingest and refresh cycles), in ms."""
    total, seen = 0.0, False
    for _, e in window_spans(rd):
        if e.name in names:
            total += e.dur
            seen = True
    if not seen or not rd.calls:
        return None
    return 1e3 * total / len(rd.calls)


def queue_wait_ms(rd) -> Optional[float]:
    """Mean wait of a worker's sweep request in the dispatcher's queue,
    from the ``sweep`` span's start to the start of the flush that
    answered it (its ``queued_s``), in ms."""
    waits = [e.args["queued_s"] for _, e in window_spans(rd)
             if e.name == "sweep" and e.lane.startswith("worker-")
             and e.args and "queued_s" in e.args]
    return 1e3 * sum(waits) / len(waits) if waits else None


def flush_pack_ms(rd) -> Optional[float]:
    """Mean host time of a dispatcher flush outside its kernel launches
    and mirror syncs (the ``flush`` span's duration less its nested
    ``launch`` and ``h2d-sync`` spans), in ms; None where no flush
    recorded a launch."""
    flushes: Dict[tuple, List] = {}
    children: Dict[tuple, List] = {}
    for i, e in window_spans(rd):
        if not e.lane.startswith("dispatcher"):
            continue
        key = (i, e.pid, e.tid)
        if e.name == "flush":
            flushes.setdefault(key, []).append(e)
        elif e.name in FLUSH_CHILDREN:
            children.setdefault(key, []).append(e)
    if not any(c.name == "launch" for cs in children.values() for c in cs):
        return None
    self_s: List[float] = []
    for key, fs in flushes.items():
        cs = sorted(children.get(key, ()), key=lambda c: c.ts)
        starts = [c.ts for c in cs]
        for f in fs:
            end = f.ts + f.dur
            inner = 0.0
            for c in cs[bisect.bisect_left(starts, f.ts):]:
                if c.ts > end:
                    break
                if c.ts + c.dur <= end + 1e-9:
                    inner += c.dur
            self_s.append(f.dur - inner)
    return 1e3 * sum(self_s) / len(self_s) if self_s else None
