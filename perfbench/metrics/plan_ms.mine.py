"""Host time of a mine's level planning on the driver lane (Tracer
"candidates", "plan" and "collect" spans, summed over the levels) per
mine, in ms."""
from perfbench.spans import ms_per_call


def read(rd):
    return ms_per_call(rd, ("candidates", "plan", "collect"))
