"""Pull-based metrics: a snapshot registry + an exact-quantile recorder.

``MetricsRegistry`` is deliberately passive — sources register a
zero-arg callable and ``snapshot()`` pulls them all under no shared
lock (each source guards its own state). That keeps the hot paths free
of any push-side bookkeeping: the scheduler/dispatcher/arena already
maintain their counters; the registry just knows how to read them.

``LatencyRecorder`` backs the serving-layer histogram. Samples land in
a per-kind bounded deque (drop-oldest beyond ``cap``), so p50/p95/p99
are EXACT over the retained window — no bucketing error — at the cost
of one lock + append per query, which is noise next to even a 5µs
snapshot hit.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = ["MetricsRegistry", "LatencyRecorder"]


class MetricsRegistry:
    """Named gauge sources, snapshotted on demand."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sources: Dict[str, Callable[[], Any]] = {}

    def register(self, name: str, fn: Callable[[], Any]) -> None:
        with self._lock:
            self._sources[name] = fn

    def unregister(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._sources)

    def snapshot(self) -> Dict[str, Any]:
        """Pull every source once; a failing source reports its error
        instead of poisoning the snapshot."""
        with self._lock:
            sources = list(self._sources.items())
        out: Dict[str, Any] = {}
        for name, fn in sources:
            try:
                out[name] = fn()
            except Exception as e:  # pragma: no cover - defensive
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out


def _percentile(sorted_xs: List[float], q: float) -> float:
    """Exact nearest-rank percentile over a sorted sample list."""
    if not sorted_xs:
        return 0.0
    n = len(sorted_xs)
    k = max(0, min(n - 1, int(round(q / 100.0 * (n - 1)))))
    return sorted_xs[k]


class LatencyRecorder:
    """Per-kind latency samples with exact p50/p95/p99.

    ``record(kind, seconds, n)`` books ``n`` queries that each took
    ``seconds`` (a batched call records its per-query share). The
    window keeps the most recent ``cap`` samples per kind.
    """

    def __init__(self, cap: int = 100_000):
        self.cap = int(cap)
        self._lock = threading.Lock()
        self._samples: Dict[str, deque] = {}
        self._count: Dict[str, int] = {}

    def record(self, kind: str, seconds: float, n: int = 1) -> None:
        if n <= 0:
            return
        with self._lock:
            d = self._samples.get(kind)
            if d is None:
                d = self._samples[kind] = deque(maxlen=self.cap)
                self._count[kind] = 0
            if n == 1:
                d.append(seconds)
            else:
                d.extend([seconds] * n)
            self._count[kind] += n

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._count)

    def percentiles(self, kind: Optional[str] = None) -> Dict[str, Any]:
        """{kind: {n, p50, p95, p99, max}} (seconds), or one kind's row."""
        with self._lock:
            items = [(k, list(d)) for k, d in self._samples.items()
                     if kind is None or k == kind]
            counts = dict(self._count)
        out: Dict[str, Any] = {}
        for k, xs in items:
            xs.sort()
            out[k] = {
                "n": counts.get(k, len(xs)),
                "p50": _percentile(xs, 50.0),
                "p95": _percentile(xs, 95.0),
                "p99": _percentile(xs, 99.0),
                "max": xs[-1] if xs else 0.0,
            }
        if kind is not None:
            return out.get(kind, {"n": 0, "p50": 0.0, "p95": 0.0,
                                  "p99": 0.0, "max": 0.0})
        return out
