"""Observability: ring-buffer tracing, exporters, metrics, stats schema.

Usage (batch mining)::

    from repro_torch.obs import Tracer, write_chrome_trace, summary_table
    tr = Tracer()
    supports, met = mine(bitmaps, min_support, trace=tr)
    write_chrome_trace(tr, "mine.trace.json")   # open in ui.perfetto.dev
    print(summary_table(tr, wall_s=met.wall_s))

Tracing is off by default: every instrumented site holds a tracer
reference that is ``None`` unless the caller passed one, so the
disabled fast path is a single ``is not None`` test. See
``repro_torch.obs.tracer`` for the ring-buffer design,
``repro_torch.obs.schema`` for the merged-stats schema and
``repro_torch.obs.registry`` for the pull-based metrics snapshot API.
"""
from repro_torch.obs.export import (  # noqa: F401
    check_nesting, chrome_trace, summary_table, time_in_state,
    write_chrome_trace,
)
from repro_torch.obs.registry import LatencyRecorder, MetricsRegistry  # noqa: F401
from repro_torch.obs.tracer import TraceEvent, Tracer  # noqa: F401
from repro_torch.obs import schema  # noqa: F401

__all__ = [
    "Tracer", "TraceEvent", "chrome_trace", "write_chrome_trace",
    "summary_table", "time_in_state", "check_nesting",
    "MetricsRegistry", "LatencyRecorder", "schema",
]
