"""Observability: the stats schema and the pull-based metrics registry.

The tracer and its exporters belong to a later slice of the port; every
instrumented site keeps its ``tracer is None`` guard so they slot in.
"""
from repro_torch.obs import schema  # noqa: F401
from repro_torch.obs.registry import LatencyRecorder, MetricsRegistry  # noqa: F401

__all__ = ["MetricsRegistry", "LatencyRecorder", "schema"]
