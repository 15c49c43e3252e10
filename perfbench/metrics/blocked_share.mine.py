"""Worker lanes' time blocked on the dispatcher over their extent
(repro_torch.obs.time_in_state), in %."""
from perfbench.readers import blocked_share as read  # noqa: F401
