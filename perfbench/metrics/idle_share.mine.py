"""Share of the window's mines in which the card ran nothing, in %."""
from perfbench.readers import idle_share as read  # noqa: F401
