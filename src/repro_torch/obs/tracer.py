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

Garbage collections get a lane of their own, ``gc``: between
``hook_gc`` and ``unhook_gc`` the tracer holds one ``gc.callbacks``
entry that records a ``gc`` span per collection, whichever thread
triggered it. Collections never overlap (the interpreter runs one at a
time), so the lane's ring still has one writer at a time. The engines
hook it only for the length of a traced call.
"""
from __future__ import annotations

import gc
import itertools
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

__all__ = ["Tracer", "TraceEvent", "with_gc_spans"]


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
    """Single-writer circular event buffer (one owner thread).

    The buffer grows by appends until it holds ``cap`` events and wraps
    from then on, so a lane holds only the events it took: a large
    ``cap`` costs no memory up front, and the garbage collector, which
    walks every list it tracks, never walks empty slots."""

    __slots__ = ("cap", "buf", "idx", "n", "tid", "name", "pid", "sort")

    def __init__(self, cap: int, tid: int, name: str, pid: int = 0,
                 sort: Optional[int] = None):
        self.cap = cap
        self.buf: List[tuple] = []
        self.idx = 0        # next write slot
        self.n = 0          # total events ever appended
        self.tid = tid
        self.name = name
        self.pid = pid
        self.sort = sort

    def append(self, ev: tuple) -> None:
        i = self.idx
        if self.n < self.cap:
            self.buf.append(ev)
        else:
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
            return self.buf[: self.idx]
        i = self.idx
        return self.buf[i:] + self.buf[:i]


# the gc lane sorts after every worker and dispatcher lane
GC_LANE_SORT = 1 << 20


class _GcHook:
    """The ``gc.callbacks`` entry: a span per collection on the gc lane,
    stamped with the tracer's clock, with the generation, the objects
    collected and the name of the thread whose allocation (or
    ``gc.collect``) triggered it."""

    __slots__ = ("ring", "tracer", "t0")

    def __init__(self, ring: _Ring, tracer: "Tracer"):
        self.ring = ring
        self.tracer = tracer
        self.t0 = 0.0

    def __call__(self, phase: str, info: Dict[str, int]) -> None:
        if phase == "start":
            self.t0 = self.tracer.now()
            return
        t1 = self.tracer.now()
        self.ring.append(("X", "gc", "gc", self.t0 - self.tracer._epoch,
                          t1 - self.t0,
                          {"generation": info["generation"],
                           "collected": info["collected"],
                           "thread": threading.current_thread().name}))


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
        self._gc_lock = threading.Lock()
        self._gc_users = 0
        self._gc_hook: Optional[_GcHook] = None
        self._gc_ring: Optional[_Ring] = None
        self._serials = itertools.count(1)

    # ---- record path -------------------------------------------------

    def now(self) -> float:
        return time.perf_counter()

    def _add_ring(self, name: str, pid: int = 0,
                  sort: Optional[int] = None) -> _Ring:
        with self._lock:
            r = _Ring(self.ring_size, self._next_tid, name, pid, sort)
            self._next_tid += 1
            self._rings.append(r)
        return r

    def _new_ring(self, name: str, pid: int = 0,
                  sort: Optional[int] = None) -> _Ring:
        r = self._tls.ring = self._add_ring(name, pid, sort)
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

    def serial(self) -> int:
        """The next of this tracer's serial ids (1, 2, ...), from any
        thread: an identifier that spans of several lanes share."""
        return next(self._serials)

    def hook_gc(self) -> None:
        """Record every garbage collection as a ``gc`` span on lane
        ``gc`` until the matching :meth:`unhook_gc`. Calls nest and may
        overlap across threads: the first installs the one
        ``gc.callbacks`` entry, the last removes it, after which
        neither the interpreter nor the entry refers to this tracer."""
        with self._gc_lock:
            self._gc_users += 1
            if self._gc_users > 1:
                return
            if self._gc_ring is None:
                # made here, never inside the callback: a collection can
                # start while this thread holds ``_lock``
                self._gc_ring = self._add_ring("gc", sort=GC_LANE_SORT)
            self._gc_hook = _GcHook(self._gc_ring, self)
            gc.callbacks.append(self._gc_hook)

    def unhook_gc(self) -> None:
        with self._gc_lock:
            self._gc_users -= 1
            if self._gc_users > 0:
                return
            hook, self._gc_hook = self._gc_hook, None
            gc.callbacks.remove(hook)

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


def with_gc_spans(tracer: Optional[Tracer], fn, /, *args, **kwargs):
    """``fn(*args, **kwargs)`` with ``tracer`` recording the garbage
    collections that run meanwhile (:meth:`Tracer.hook_gc`); with no
    tracer, a plain call."""
    if tracer is None:
        return fn(*args, **kwargs)
    tracer.hook_gc()
    try:
        return fn(*args, **kwargs)
    finally:
        tracer.unhook_gc()
