"""Lock-minimal per-worker ring-buffer tracer.

Every thread that emits events owns a private ``_Ring`` — a fixed-size
circular buffer reached through ``threading.local`` — so the record
path takes NO lock: one ``perf_counter`` read, one tuple build, one
list-slot store. The tracer's global lock is touched only when a
thread registers its ring (once per thread) and at collection time.
When a ring fills, new events overwrite the oldest (drop-oldest); the
``dropped`` counter keeps the loss honest.

The disabled fast path is structural, not a flag check inside the
tracer: instrumentation sites hold ``tracer = None`` and guard with
``if tr is not None`` — one local load and an identity test, so an
untraced run pays nothing per event. A constructed ``Tracer`` is
always live.

Spans are recorded as *complete* events at span end (Chrome trace
``ph="X"``): the site captures ``t0 = tracer.now()`` before the work
and calls ``tracer.span(name, t0)`` after, which stamps the duration.
That makes one ring append per span and means per-lane append order is
span *end* order — sorting by start time (ties: longer first)
reconstructs the nesting, which is how the exporter's time-in-state
accounting works.

Lanes map onto Chrome trace (pid, tid): ``pid`` is the host rank and
``tid`` is a per-ring serial; ``set_lane`` names the calling thread's
lane ("worker-3", "dispatcher-0", "driver", ...) and pins its sort
position.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

__all__ = ["Tracer", "TraceEvent"]


class TraceEvent(NamedTuple):
    """One collected event, flattened with its lane identity.

    ``ts``/``dur`` are seconds relative to the tracer epoch; the
    Chrome exporter converts to µs. ``ph`` follows the trace-event
    format: "X" complete span, "I" instant, "C" counter.
    """

    ph: str
    name: str
    cat: str
    ts: float
    dur: float
    args: Optional[Dict[str, Any]]
    pid: int
    tid: int
    lane: str


class _Ring:
    """Single-writer circular event buffer (one owner thread)."""

    __slots__ = ("cap", "buf", "idx", "n", "tid", "name", "pid", "sort")

    def __init__(self, cap: int, tid: int, name: str, pid: int = 0,
                 sort: Optional[int] = None):
        self.cap = cap
        self.buf: List[Optional[tuple]] = [None] * cap
        self.idx = 0        # next write slot
        self.n = 0          # total events ever appended
        self.tid = tid
        self.name = name
        self.pid = pid
        self.sort = sort

    def append(self, ev: tuple) -> None:
        i = self.idx
        self.buf[i] = ev
        self.idx = 0 if i + 1 == self.cap else i + 1
        self.n += 1

    @property
    def dropped(self) -> int:
        return max(0, self.n - self.cap)

    def snapshot(self) -> List[tuple]:
        """Events in append order, oldest first (last ``cap`` kept).

        The unwrapped branch holds only while fewer than ``cap`` events
        arrived: a ring that took exactly ``cap`` has ``idx`` back at 0
        and its events in ``buf[0:cap]``, which the wrapped branch
        returns whole. (The reference tracer tests ``n <= cap`` here and
        so returns nothing for an exactly-full ring.)"""
        if self.n < self.cap:
            return [e for e in self.buf[: self.idx] if e is not None]
        i = self.idx
        return [e for e in self.buf[i:] + self.buf[:i] if e is not None]


class Tracer:
    """Collects span/instant/counter events into per-thread rings.

    Record methods (``span``/``instant``/``counter``) are safe from any
    thread and lock-free after the thread's first event. Collection
    (``events()``/``rings()``) merges all rings preserving each lane's
    internal order; it is meant to run at quiescence (after ``mine()``
    returns) but tolerates concurrent writers — a torn read can at worst
    miss or duplicate boundary events, never corrupt collected tuples.
    """

    def __init__(self, ring_size: int = 65536):
        if ring_size < 8:
            raise ValueError("ring_size must be >= 8")
        self.ring_size = int(ring_size)
        self._epoch = time.perf_counter()
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._rings: List[_Ring] = []
        self._next_tid = 1

    # ---- record path -------------------------------------------------

    def now(self) -> float:
        return time.perf_counter()

    def _new_ring(self, name: str, pid: int = 0,
                  sort: Optional[int] = None) -> _Ring:
        with self._lock:
            r = _Ring(self.ring_size, self._next_tid, name, pid, sort)
            self._next_tid += 1
            self._rings.append(r)
        self._tls.ring = r
        return r

    def _ring(self) -> _Ring:
        r = getattr(self._tls, "ring", None)
        if r is None:
            r = self._new_ring(threading.current_thread().name)
        return r

    def set_lane(self, name: str, sort_index: Optional[int] = None,
                 pid: int = 0) -> None:
        """Name the calling thread's lane (idempotent, renames in place)."""
        r = getattr(self._tls, "ring", None)
        if r is None:
            self._new_ring(name, pid, sort_index)
        else:
            r.name, r.pid = name, pid
            if sort_index is not None:
                r.sort = sort_index

    def span(self, name: str, t0: float, cat: str = "span",
             args: Optional[Dict[str, Any]] = None) -> None:
        """Record a complete span that started at ``t0 = tracer.now()``."""
        t1 = time.perf_counter()
        self._ring().append(("X", name, cat, t0 - self._epoch, t1 - t0, args))

    def instant(self, name: str, cat: str = "event",
                args: Optional[Dict[str, Any]] = None) -> None:
        ts = time.perf_counter() - self._epoch
        self._ring().append(("I", name, cat, ts, 0.0, args))

    def counter(self, name: str, values: Dict[str, Any]) -> None:
        """Record a counter sample (Perfetto draws these as tracks)."""
        ts = time.perf_counter() - self._epoch
        self._ring().append(("C", name, "counter", ts, 0.0, dict(values)))

    # ---- collection --------------------------------------------------

    def rings(self) -> List[_Ring]:
        with self._lock:
            rs = list(self._rings)
        rs.sort(key=lambda r: (r.pid, r.sort if r.sort is not None else 1 << 30,
                               r.tid))
        return rs

    def events(self) -> List[TraceEvent]:
        """All events, lane by lane, per-lane append order preserved."""
        out: List[TraceEvent] = []
        for r in self.rings():
            for ph, name, cat, ts, dur, args in r.snapshot():
                out.append(TraceEvent(ph, name, cat, ts, dur, args,
                                      r.pid, r.tid, r.name))
        return out

    def dropped(self) -> int:
        return sum(r.dropped for r in self.rings())

    def lanes(self) -> List[Tuple[int, int, str]]:
        """(pid, tid, name) per registered lane, display order."""
        return [(r.pid, r.tid, r.name) for r in self.rings()]

    def lane_names(self) -> List[str]:
        return [r.name for r in self.rings()]
