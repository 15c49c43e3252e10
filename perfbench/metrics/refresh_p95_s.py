"""95th percentile of the window's ingest and refresh cycles, in s."""
from perfbench.readers import p95


def read(rd):
    return p95(rd.cycle_s)
