"""PyTorch/CUDA port of the task-parallel frequent-pattern miner.

The package mirrors ``repro``'s layout module for module and imports
neither JAX nor ``repro``. Batch mining runs on an NVIDIA GPU through two
hand-written CUDA kernels (``repro_torch.kernels``); ``mine`` runs on the
card unless the caller passes ``device="cpu"``.
"""
from repro_torch.core.fpm import mine, mine_serial  # noqa: F401

__all__ = ["mine", "mine_serial"]
