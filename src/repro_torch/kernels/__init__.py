"""Hand-written CUDA kernels for Hopper (``sm_90a``), one package each.

Each package holds ``ref.py`` (the plain PyTorch version) and ``ops.py``
(the wrapper that launches the kernel on a CUDA tensor and runs the plain
version on a CPU tensor). The CUDA sources live in ``csrc/`` and are
compiled on first use by :mod:`repro_torch.kernels._build`.
"""
