"""Plain PyTorch versions of the ``bitmap_join`` and ``bitmap_join_many``
kernels.

Words are int32 tensors holding the uint32 bit patterns. This PyTorch
build has no popcount op, and ``>>`` on int32 is arithmetic (it copies
bit 31 down), so :func:`popcount32` masks after every shift and counts
the two 16-bit halves separately: every intermediate stays in
[0, 0xFFFF], where no int32 arithmetic can overflow.
"""
from __future__ import annotations

import torch


def _popcount16(v: torch.Tensor) -> torch.Tensor:
    """Bit count of int32 values in [0, 0xFFFF] (SWAR)."""
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element bit count of int32 words read as uint32."""
    return _popcount16(x & 0xFFFF) + _popcount16((x >> 16) & 0xFFFF)


def bitmap_join_many_ref(prefixes: torch.Tensor, exts: torch.Tensor
                         ) -> torch.Tensor:
    """prefixes [B, W] int32, exts [B, E, W] int32 -> counts [B, E] int32:
    ``counts[b, e] = Σ_w popcount(prefixes[b, w] & exts[b, e, w])``."""
    joined = exts & prefixes[:, None, :]
    return popcount32(joined).sum(dim=2, dtype=torch.int32)


def bitmap_join_ref(prefix: torch.Tensor, exts: torch.Tensor) -> torch.Tensor:
    """prefix [W] int32, exts [E, W] int32 -> counts [E] int32:
    ``counts[e] = Σ_w popcount(prefix[w] & exts[e, w])``."""
    joined = exts & prefix[None, :]
    return popcount32(joined).sum(dim=1, dtype=torch.int32)


def bitmap_join_many_rows_ref(prefix_rows: torch.Tensor, pidx: torch.Tensor,
                              ext_rows: torch.Tensor, eidx: torch.Tensor,
                              n_words: int) -> torch.Tensor:
    """The indexed form: prefix_rows and ext_rows are int32 row stores,
    pidx [B] or [B, L] and eidx [B, E] int32 row indices -> counts [B, E]
    int32, ``counts[b, e] = Σ_{w < n_words} popcount(P_b[w] &
    ext_rows[eidx[b, e], w])``. ``P_b`` is ``prefix_rows[pidx[b]]``, or
    for pidx [B, L] the AND of ``prefix_rows[pidx[b, j]]`` over the tuple,
    which ends at the first -1 past j = 0. An index of -1 at ``pidx[b,
    0]`` or in eidx (a pad request or lane) counts 0."""
    tuples = pidx if pidx.dim() == 2 else pidx[:, None]
    rows = prefix_rows[tuples.clamp(min=0).long(), :n_words]   # [B, L, W]
    in_tuple = torch.cumprod((tuples >= 0).int(), dim=1).bool()
    p = rows[:, 0]
    for j in range(1, tuples.shape[1]):
        p = p & torch.where(in_tuple[:, j, None], rows[:, j], -1)
    x = ext_rows[eidx.clamp(min=0).long(), :n_words]
    live = (tuples[:, 0] >= 0)[:, None] & (eidx >= 0)
    return torch.where(live, bitmap_join_many_ref(p, x), 0)
