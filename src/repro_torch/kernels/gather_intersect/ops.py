"""Wrapper of the ``gather_intersect_many`` CUDA kernel.

On a CUDA tensor the wrapper launches the kernel (``csrc/
gather_intersect_many.cu``) or raises; on a CPU tensor it runs the plain
version in ``ref.py``. ``launches`` counts kernel launches and nothing
else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_intersect.ref import (
    gather_intersect_many_ref)

NAME = "gather_intersect_many"
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

launches = 0


def _check(tids: torch.Tensor, exts: torch.Tensor) -> None:
    if tids.dtype != torch.int32 or exts.dtype != torch.int32:
        raise TypeError("gather_intersect_many takes int32 tids and words, "
                        f"got {tids.dtype} and {exts.dtype}")
    if (exts.dim() != 3 or tids.dim() != 2
            or tids.shape[0] != exts.shape[0]):
        raise ValueError("gather_intersect_many takes tids [B, S] and exts "
                         f"[B, E, W], got {tuple(tids.shape)} and "
                         f"{tuple(exts.shape)}")
    if tids.device != exts.device:
        raise ValueError("tids and exts lie on different devices: "
                         f"{tids.device} and {exts.device}")


def _launch(tids: torch.Tensor, exts: torch.Tensor) -> torch.Tensor:
    global launches
    b, e, w = exts.shape
    s = tids.shape[1]
    if not (tids.is_contiguous() and exts.is_contiguous()):
        raise ValueError("gather_intersect_many takes contiguous tensors")
    if b > 65535:
        raise ValueError(f"batch of {b} exceeds the kernel's grid (65535)")
    out = torch.empty((b, e), dtype=torch.int32, device=exts.device)
    lib = _build.library(NAME, _ARGTYPES)
    stream = torch.cuda.current_stream(exts.device).cuda_stream
    code = lib.gather_intersect_many(tids.data_ptr(), exts.data_ptr(),
                                     out.data_ptr(), b, e, s, w, stream)
    _build.check(lib, NAME, code)
    launches += 1
    return out


def gather_intersect_many(tids: torch.Tensor, exts: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Batched sparse sweep: counts[b, e] = |tids[b] ∩ exts[b, e]|.

    tids [B, S] int32 padded with -1; exts [B, E, W] int32 word-columns
    -> [B, E] int32; the optional mask [B, E] bool zeroes padded
    extension lanes. An empty tid axis (S == 0), like any other empty
    dimension, is all-zero without a launch."""
    _check(tids, exts)
    b, e, w = exts.shape
    if b == 0 or e == 0 or w == 0 or tids.shape[1] == 0:
        counts = torch.zeros((b, e), dtype=torch.int32, device=exts.device)
    elif exts.is_cuda:
        counts = _launch(tids, exts)
    elif exts.device.type == "cpu":
        counts = gather_intersect_many_ref(tids, exts)
    else:
        raise ValueError(f"no gather_intersect_many for device {exts.device}")
    if mask is not None:
        counts = torch.where(mask, counts, 0)
    return counts
