"""PyTorch/CUDA port of the task-parallel frequent-pattern miner.

The package mirrors ``repro``'s layout module for module and imports
neither JAX nor ``repro``. Batch mining (on one host or
several), streaming refresh, query serving and multi-tenant hubs run on
an NVIDIA GPU through hand-written CUDA kernels (``repro_torch.kernels``);
``mine``, ``StreamingMiner`` and ``TenantHub`` run on the card unless the
caller passes ``device="cpu"``.
"""
from repro_torch.core.fpm import mine, mine_serial  # noqa: F401
from repro_torch.core.streaming import (PatternServer,  # noqa: F401
                                        PatternSnapshot, StreamingMiner,
                                        Tenant, TenantHub)

__all__ = ["mine", "mine_serial", "StreamingMiner", "PatternServer",
           "PatternSnapshot", "Tenant", "TenantHub"]
