"""Candidates answered from known supports over all candidates of the
window's refreshes (RefreshReport: reused, swept_delta, swept_full), in %."""
from perfbench.readers import reused_share as read  # noqa: F401
