"""Host-to-device bytes per mine (MiningMetrics.h2d_bytes), in MB."""
from perfbench.readers import h2d_mb as read  # noqa: F401
