"""Host time of a refresh's delta bookkeeping on the refreshing lane
(Tracer "dirty-items", "candidates", "plan", "collect", "drop-unswept"
and "assemble" spans) per ingest and refresh cycle, in ms."""
from perfbench.spans import ms_per_call


def read(rd):
    return ms_per_call(rd, ("dirty-items", "candidates", "plan", "collect",
                            "drop-unswept", "assemble"))
