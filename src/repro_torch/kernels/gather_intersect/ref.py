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


def gather_intersect_many_rows_ref(tids: torch.Tensor, lens: torch.Tensor,
                                   ext_rows: torch.Tensor,
                                   eidx: torch.Tensor,
                                   n_words: int) -> torch.Tensor:
    """The indexed form: tids [B, S] int32 (-1 = padded lane), lens [B]
    int32 (tids at s >= lens[b] are not read), ext_rows an int32 row
    store, eidx [B, E] int32 row indices (-1 = pad lane, count 0) ->
    counts [B, E] int32. A tid past the first ``n_words`` words of a row
    reads word ``n_words - 1``."""
    s = tids.shape[1]
    valid = (tids >= 0) & (torch.arange(s, device=tids.device)[None, :]
                           < lens[:, None])
    t = torch.where(valid, tids, 0)
    wi = torch.clamp(t >> 5, max=n_words - 1).long()
    rows = eidx.clamp(min=0).long()
    words = ext_rows[rows[:, :, None], wi[:, None, :]]
    bits = (words >> (t & 31)[:, None, :]) & 1
    keep = valid[:, None, :] & (eidx >= 0)[:, :, None]
    return torch.where(keep, bits, 0).sum(dim=2, dtype=torch.int32)
