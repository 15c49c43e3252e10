"""Garbage collection (Tracer "gc" spans, lane "gc") per ingest and
refresh cycle of the window, in ms."""
from perfbench.spans import ms_per_call


def read(rd):
    return ms_per_call(rd, ("gc",))
