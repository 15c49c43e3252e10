"""Sweep requests per dispatcher flush over the window's mines
(MiningMetrics.batch_occupancy, weighted by flushes)."""
from perfbench.readers import occupancy as read  # noqa: F401
