"""PyTorch/CUDA port of the task-parallel frequent-pattern miner.

The package mirrors ``repro``'s layout module for module and imports
neither JAX nor ``repro``. Batch mining (on one host, several hosts or
a mesh of device shards), streaming refresh, query serving and
multi-tenant hubs run on an NVIDIA GPU through hand-written CUDA kernels
(``repro_torch.kernels``); ``mine``, ``mine_distributed``,
``StreamingMiner`` and ``TenantHub`` run on the card unless the caller
passes ``device="cpu"``.
"""
from repro_torch.core.distributed_fpm import mine_distributed  # noqa: F401
from repro_torch.core.fpm import (mesh_over_devices, mine,  # noqa: F401
                                  mine_serial)
from repro_torch.core.streaming import (PatternServer,  # noqa: F401
                                        PatternSnapshot, StreamingMiner,
                                        Tenant, TenantHub)

__all__ = ["mine", "mine_serial", "mine_distributed", "mesh_over_devices",
           "StreamingMiner", "PatternServer",
           "PatternSnapshot", "Tenant", "TenantHub"]
