"""Wrappers of the ``bitmap_join_many`` and ``bitmap_join`` CUDA kernels.

On a CUDA tensor a wrapper launches its kernel (``csrc/
bitmap_join_many.cu``, ``csrc/bitmap_join.cu``) or raises; on a CPU
tensor it runs the plain version in ``ref.py``. ``launches`` counts
``bitmap_join_many`` launches and ``single_launches`` counts
``bitmap_join`` launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitmap_join.ref import (bitmap_join_many_ref,
                                                 bitmap_join_ref)

NAME = "bitmap_join_many"
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
SINGLE_NAME = "bitmap_join"
_SINGLE_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p])

launches = 0
single_launches = 0


def _check(prefixes: torch.Tensor, exts: torch.Tensor) -> None:
    if prefixes.dtype != torch.int32 or exts.dtype != torch.int32:
        raise TypeError("bitmap_join_many takes int32 words, got "
                        f"{prefixes.dtype} and {exts.dtype}")
    if exts.dim() != 3 or prefixes.shape != (exts.shape[0], exts.shape[2]):
        raise ValueError("bitmap_join_many takes prefixes [B, W] and exts "
                         f"[B, E, W], got {tuple(prefixes.shape)} and "
                         f"{tuple(exts.shape)}")
    if prefixes.device != exts.device:
        raise ValueError("prefixes and exts lie on different devices: "
                         f"{prefixes.device} and {exts.device}")


def _launch(prefixes: torch.Tensor, exts: torch.Tensor) -> torch.Tensor:
    global launches
    b, e, w = exts.shape
    if not (prefixes.is_contiguous() and exts.is_contiguous()):
        raise ValueError("bitmap_join_many takes contiguous tensors")
    if b > 65535:
        raise ValueError(f"batch of {b} exceeds the kernel's grid (65535)")
    out = torch.empty((b, e), dtype=torch.int32, device=exts.device)
    lib = _build.library(NAME, _ARGTYPES)
    stream = torch.cuda.current_stream(exts.device).cuda_stream
    code = lib.bitmap_join_many(prefixes.data_ptr(), exts.data_ptr(),
                                out.data_ptr(), b, e, w, stream)
    _build.check(lib, NAME, code)
    launches += 1
    return out


def bitmap_join_many(prefixes: torch.Tensor, exts: torch.Tensor,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """Batched multi-prefix join: counts[b, e] = |prefixes[b] ∧ exts[b, e]|.

    prefixes [B, W] int32, exts [B, E, W] int32 (uint32 words viewed as
    int32) -> [B, E] int32; the optional mask [B, E] bool zeroes padded
    lanes of ragged batches. An empty batch launches nothing."""
    _check(prefixes, exts)
    b, e, w = exts.shape
    if b == 0 or e == 0 or w == 0:
        counts = torch.zeros((b, e), dtype=torch.int32, device=exts.device)
    elif exts.is_cuda:
        counts = _launch(prefixes, exts)
    elif exts.device.type == "cpu":
        counts = bitmap_join_many_ref(prefixes, exts)
    else:
        raise ValueError(f"no bitmap_join_many for device {exts.device}")
    if mask is not None:
        counts = torch.where(mask, counts, 0)
    return counts


def bitmap_join(prefix: torch.Tensor, exts: torch.Tensor) -> torch.Tensor:
    """Single-prefix join: counts[e] = |prefix ∧ exts[e]|.

    prefix [W] int32, exts [E, W] int32 (uint32 words viewed as int32)
    -> [E] int32. An empty E or W launches nothing."""
    global single_launches
    if prefix.dtype != torch.int32 or exts.dtype != torch.int32:
        raise TypeError("bitmap_join takes int32 words, got "
                        f"{prefix.dtype} and {exts.dtype}")
    if exts.dim() != 2 or prefix.shape != (exts.shape[1],):
        raise ValueError("bitmap_join takes prefix [W] and exts [E, W], "
                         f"got {tuple(prefix.shape)} and "
                         f"{tuple(exts.shape)}")
    if prefix.device != exts.device:
        raise ValueError("prefix and exts lie on different devices: "
                         f"{prefix.device} and {exts.device}")
    e, w = exts.shape
    if e == 0 or w == 0:
        return torch.zeros(e, dtype=torch.int32, device=exts.device)
    if exts.device.type == "cpu":
        return bitmap_join_ref(prefix, exts)
    if not exts.is_cuda:
        raise ValueError(f"no bitmap_join for device {exts.device}")
    if not (prefix.is_contiguous() and exts.is_contiguous()):
        raise ValueError("bitmap_join takes contiguous tensors")
    out = torch.empty(e, dtype=torch.int32, device=exts.device)
    lib = _build.library(SINGLE_NAME, _SINGLE_ARGTYPES)
    stream = torch.cuda.current_stream(exts.device).cuda_stream
    code = lib.bitmap_join(prefix.data_ptr(), exts.data_ptr(),
                           out.data_ptr(), e, w, stream)
    _build.check(lib, SINGLE_NAME, code)
    single_launches += 1
    return out
