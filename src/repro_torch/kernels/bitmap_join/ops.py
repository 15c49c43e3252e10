"""Wrappers of the ``bitmap_join_many`` and ``bitmap_join`` CUDA kernels.

On a CUDA tensor a wrapper launches its kernel (``csrc/
bitmap_join_many.cu``, ``csrc/bitmap_join.cu``) or raises; on a CPU
tensor it runs the plain version in ``ref.py``.

``bitmap_join_many_rows`` is the indexed entry the kernel backend calls:
it takes row stores (the arena's device mirror of one segment) and int32
row indices, one prefix row or a tuple of them per request.
``bitmap_join_many`` keeps the reference's gathered form ``(prefixes,
exts, mask)`` and launches the same kernel with identity indices.
``launches`` counts ``bitmap_join_many`` kernel launches through either
entry and ``single_launches`` counts ``bitmap_join`` launches, and
nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitmap_join.ref import (bitmap_join_many_ref,
                                                 bitmap_join_many_rows_ref,
                                                 bitmap_join_ref)

_MANY = _build.Kernel(
    "bitmap_join_many",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
    + [ctypes.c_void_p])
_SINGLE = _build.Kernel(
    "bitmap_join", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    + [ctypes.c_void_p])
ROWS_PER_BLOCK = 8          # the kernel's extension rows per block

launches = 0
single_launches = 0


def _launch_rows(prefix_rows, pidx, ext_rows, eidx, n_words):
    global launches
    b, e = eidx.shape
    if not (pidx.is_contiguous() and eidx.is_contiguous()):
        raise ValueError("bitmap_join_many takes contiguous index tensors")
    _build.check_grid(b, e, ROWS_PER_BLOCK)
    out = torch.empty((b, e), dtype=torch.int32, device=eidx.device)
    tuple_len = pidx.shape[1] if pidx.dim() == 2 else 1
    _MANY(eidx.device, prefix_rows.data_ptr(), pidx.data_ptr(),
          ext_rows.data_ptr(), eidx.data_ptr(), out.data_ptr(), b, e,
          n_words, tuple_len, prefix_rows.stride(0), ext_rows.stride(0))
    launches += 1
    return out


def bitmap_join_many_rows(prefix_rows: torch.Tensor, pidx: torch.Tensor,
                          ext_rows: torch.Tensor, eidx: torch.Tensor,
                          n_words: int) -> torch.Tensor:
    """Indexed batched join: ``counts[b, e] = Σ_{w < n_words}
    popcount(P_b[w] & ext_rows[eidx[b, e], w])``, where ``P_b`` is
    ``prefix_rows[pidx[b]]`` for pidx [B], or for pidx [B, L] the AND of
    the tuple ``prefix_rows[pidx[b, j]]``, j = 0, 1, ... up to the first
    -1 past j = 0.

    prefix_rows and ext_rows are int32 row stores [rows, width] (on the
    mining path both are the arena's device mirror of one segment), pidx
    [B] or [B, L] and eidx [B, E] int32 row indices -> [B, E] int32. An
    index of -1 at ``pidx[b]`` (``pidx[b, 0]``) or in eidx marks a pad
    request or lane, reads nothing and counts 0; every other index must
    name a row of its store. Only ``n_words`` words of a row are read.
    An empty batch or ``n_words == 0`` launches nothing."""
    _build.check_store("prefix_rows", prefix_rows, n_words)
    _build.check_store("ext_rows", ext_rows, n_words)
    if pidx.dim() == 2:
        _build.check_index("pidx", pidx, 2)
        if pidx.shape[1] == 0:
            raise ValueError("pidx [B, L] needs L >= 1")
    else:
        _build.check_index("pidx", pidx, 1)
    _build.check_index("eidx", eidx, 2)
    if eidx.shape[0] != pidx.shape[0]:
        raise ValueError(f"pidx {tuple(pidx.shape)} and eidx "
                         f"{tuple(eidx.shape)} disagree on the batch")
    dev = eidx.device
    if not all(t.device == dev for t in (prefix_rows, pidx, ext_rows)):
        raise ValueError("bitmap_join_many's inputs lie on different "
                         "devices")
    b, e = eidx.shape
    if b == 0 or e == 0 or n_words == 0:
        return torch.zeros((b, e), dtype=torch.int32, device=dev)
    if dev.type == "cuda":
        return _launch_rows(prefix_rows, pidx, ext_rows, eidx, n_words)
    if dev.type == "cpu":
        return bitmap_join_many_rows_ref(prefix_rows, pidx, ext_rows, eidx,
                                         n_words)
    raise ValueError(f"no bitmap_join_many for device {dev}")


def bitmap_join_many(prefixes: torch.Tensor, exts: torch.Tensor,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """Batched multi-prefix join: counts[b, e] = |prefixes[b] ∧ exts[b, e]|.

    prefixes [B, W] int32, exts [B, E, W] int32 (uint32 words viewed as
    int32) -> [B, E] int32; the optional mask [B, E] bool zeroes padded
    lanes of ragged batches. On the card this is the indexed kernel over
    ``exts`` viewed as [B·E, W] rows with identity indices. An empty
    batch launches nothing."""
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
    b, e, w = exts.shape
    if b == 0 or e == 0 or w == 0:
        counts = torch.zeros((b, e), dtype=torch.int32, device=exts.device)
    elif exts.is_cuda:
        if not (prefixes.is_contiguous() and exts.is_contiguous()):
            raise ValueError("bitmap_join_many takes contiguous tensors")
        pidx = torch.arange(b, dtype=torch.int32, device=exts.device)
        eidx = torch.arange(b * e, dtype=torch.int32,
                            device=exts.device).view(b, e)
        counts = _launch_rows(prefixes, pidx, exts.view(b * e, w), eidx, w)
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
    _SINGLE(exts.device, prefix.data_ptr(), exts.data_ptr(), out.data_ptr(),
            e, w)
    single_launches += 1
    return out
