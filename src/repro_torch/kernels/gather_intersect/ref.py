"""Plain PyTorch version of the ``gather_intersect_many`` kernel.

counts[b, e] = |{s : tids[b, s] >= 0 and bit tids[b, s] of exts[b, e]
is set}| — one word gathered and one bit tested per (ext, tid) pair.
Words are int32 tensors holding the uint32 bit patterns; ``>>`` on int32
is arithmetic, so the bit is masked out with ``& 1`` after the shift,
which reads bit 31 correctly too.
"""
from __future__ import annotations

import torch


def gather_intersect_many_ref(tids: torch.Tensor, exts: torch.Tensor
                              ) -> torch.Tensor:
    """tids [B, S] int32 (-1 = padded lane), exts [B, E, W] int32
    -> counts [B, E] int32. A tid past the row's last word reads the
    last word, as the reference's clamp does."""
    b, e, w = exts.shape
    valid = tids >= 0
    t = torch.where(valid, tids, 0)
    wi = torch.clamp(t >> 5, max=w - 1).to(torch.int64)
    words = torch.gather(exts, 2, wi[:, None, :].expand(b, e, -1))
    bits = (words >> (t & 31)[:, None, :]) & 1
    bits = torch.where(valid[:, None, :], bits, 0)
    return bits.sum(dim=2, dtype=torch.int32)
