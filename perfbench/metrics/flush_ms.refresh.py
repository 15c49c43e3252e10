"""Mean host time of a dispatcher flush (Tracer "flush" spans) in the
window's ingest and refresh cycles, in ms."""
from perfbench.readers import flush_ms as read  # noqa: F401
