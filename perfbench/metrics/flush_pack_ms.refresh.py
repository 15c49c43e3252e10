"""Mean host time of a dispatcher flush outside its "launch" and
"h2d-sync" spans (packing the requests) in the window's ingest and
refresh cycles, in ms."""
from perfbench.spans import flush_pack_ms as read  # noqa: F401
