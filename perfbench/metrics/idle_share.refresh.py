"""Share of the window's ingest and refresh cycles in which the card
ran nothing, in %."""
from perfbench.readers import idle_share as read  # noqa: F401
