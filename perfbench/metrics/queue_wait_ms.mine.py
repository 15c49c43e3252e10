"""Mean wait of a worker's sweep request in the dispatcher's queue
before the flush that answered it (the "queued_s" of worker "sweep"
spans) in the window's mines, in ms."""
from perfbench.spans import queue_wait_ms as read  # noqa: F401
