"""Wrapper of the ``gather_intersect_many`` CUDA kernel.

On a CUDA tensor the wrapper launches the kernel (``csrc/
gather_intersect_many.cu``) or raises; on a CPU tensor it runs the plain
version in ``ref.py``.

``gather_intersect_many_rows`` is the indexed entry the kernel backend
calls: tids with their real lengths, a row store (the arena's device
mirror) and int32 row indices. ``gather_intersect_many`` keeps the
reference's gathered form ``(tids, exts, mask)`` and launches the same
kernel with identity indices. ``launches`` counts kernel launches
through either entry, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_intersect.ref import (
    gather_intersect_many_ref, gather_intersect_many_rows_ref)

_KERNEL = _build.Kernel(
    "gather_intersect_many",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong]
    + [ctypes.c_void_p])
ROWS_PER_BLOCK = 8          # the kernel's extension rows per block

launches = 0


def _launch_rows(tids, lens, ext_rows, eidx, n_words):
    global launches
    b, e = eidx.shape
    if not (tids.is_contiguous() and lens.is_contiguous()
            and eidx.is_contiguous()):
        raise ValueError("gather_intersect_many takes contiguous tids and "
                         "index tensors")
    _build.check_grid(b, e, ROWS_PER_BLOCK)
    out = torch.empty((b, e), dtype=torch.int32, device=eidx.device)
    _KERNEL(eidx.device, tids.data_ptr(), lens.data_ptr(),
            ext_rows.data_ptr(), eidx.data_ptr(), out.data_ptr(), b, e,
            tids.shape[1], n_words, ext_rows.stride(0))
    launches += 1
    return out


def gather_intersect_many_rows(tids: torch.Tensor, lens: torch.Tensor,
                               ext_rows: torch.Tensor, eidx: torch.Tensor,
                               n_words: int) -> torch.Tensor:
    """Indexed sparse sweep: ``counts[b, e] = #{s < lens[b] : tids[b, s]
    >= 0 and bit tids[b, s] of ext_rows[eidx[b, e]] is set}``.

    tids [B, S] int32 (-1 = padded lane), lens [B] int32, ext_rows an
    int32 row store [rows, width] (on the mining path the arena's device
    mirror), eidx [B, E] int32 row indices -> [B, E] int32. An index of
    -1 marks a pad lane, reads nothing and counts 0; every other index
    must name a row of the store. A tid past the first ``n_words`` words
    reads word ``n_words - 1``. An empty batch, S == 0 or ``n_words ==
    0`` launches nothing."""
    _build.check_store("ext_rows", ext_rows, n_words)
    _build.check_index("tids", tids, 2)
    _build.check_index("lens", lens, 1)
    _build.check_index("eidx", eidx, 2)
    if not tids.shape[0] == lens.shape[0] == eidx.shape[0]:
        raise ValueError(f"tids {tuple(tids.shape)}, lens "
                         f"{tuple(lens.shape)} and eidx {tuple(eidx.shape)} "
                         "disagree on the batch")
    dev = eidx.device
    if not all(t.device == dev for t in (tids, lens, ext_rows)):
        raise ValueError("gather_intersect_many's inputs lie on different "
                         "devices")
    b, e = eidx.shape
    if b == 0 or e == 0 or tids.shape[1] == 0 or n_words == 0:
        return torch.zeros((b, e), dtype=torch.int32, device=dev)
    if dev.type == "cuda":
        return _launch_rows(tids, lens, ext_rows, eidx, n_words)
    if dev.type == "cpu":
        return gather_intersect_many_rows_ref(tids, lens, ext_rows, eidx,
                                              n_words)
    raise ValueError(f"no gather_intersect_many for device {dev}")


def gather_intersect_many(tids: torch.Tensor, exts: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Batched sparse sweep: counts[b, e] = |tids[b] ∩ exts[b, e]|.

    tids [B, S] int32 padded with -1; exts [B, E, W] int32 word-columns
    -> [B, E] int32; the optional mask [B, E] bool zeroes padded
    extension lanes. On the card this is the indexed kernel over ``exts``
    viewed as [B·E, W] rows with identity indices and every length S. An
    empty tid axis (S == 0), like any other empty dimension, is all-zero
    without a launch."""
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
    b, e, w = exts.shape
    s = tids.shape[1]
    if b == 0 or e == 0 or w == 0 or s == 0:
        counts = torch.zeros((b, e), dtype=torch.int32, device=exts.device)
    elif exts.is_cuda:
        if not (tids.is_contiguous() and exts.is_contiguous()):
            raise ValueError("gather_intersect_many takes contiguous "
                             "tensors")
        lens = torch.full((b,), s, dtype=torch.int32, device=exts.device)
        eidx = torch.arange(b * e, dtype=torch.int32,
                            device=exts.device).view(b, e)
        counts = _launch_rows(tids, lens, exts.view(b * e, w), eidx, w)
    elif exts.device.type == "cpu":
        counts = gather_intersect_many_ref(tids, exts)
    else:
        raise ValueError(f"no gather_intersect_many for device {exts.device}")
    if mask is not None:
        counts = torch.where(mask, counts, 0)
    return counts
