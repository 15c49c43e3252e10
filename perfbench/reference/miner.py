"""Plain level-wise frequent-itemset miner: the benchmark's reference.

It re-derives every support from the transactions themselves: it packs
them into per-item bitmaps of its own, and counts each candidate by an
AND and a popcount of whole rows, level by level (Apriori candidates:
two frequent (k-1)-itemsets that share their first k-2 items). It
keeps no cache, batches nothing beyond fixed blocks of candidates, and
imports nothing of the program under test. Plain PyTorch, so it runs on
the card after a window closes and on the CPU in the tests.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Itemset = Tuple[int, ...]

# int64 words in flight per block of candidates: 2**26 words are 512 MiB
BLOCK_WORDS = 1 << 26


def min_support_count(fraction: float, n_transactions: int) -> int:
    """The absolute threshold of a fraction: floor(fraction * n), >= 1."""
    return max(1, int(fraction * n_transactions))


def pack(db: Sequence[Sequence[int]], n_items: int,
         device: "torch.device | str") -> torch.Tensor:
    """[n_items, ceil(n/32)] int64 tensor of 32-bit words: bit t % 32 of
    word t // 32 of row i is set when transaction t holds item i."""
    n = len(db)
    w = (n + 31) // 32
    lengths = np.fromiter((len(t) for t in db), np.int64, count=n)
    items = np.fromiter((i for t in db for i in t), np.int64,
                        count=int(lengths.sum()))
    tids = np.repeat(np.arange(n, dtype=np.int64), lengths)
    key = items * w + (tids >> 5)
    bit = np.left_shift(np.int64(1), tids & 31).astype(np.float64)
    # a transaction names an item once, so the bits added into one word
    # are distinct and their sum is their OR (exact below 2**53)
    words = np.bincount(key, weights=bit, minlength=n_items * w)
    return torch.from_numpy(words.astype(np.int64).reshape(n_items, w)
                            ).to(device)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Ones per row of an int64 tensor of 32-bit words (each < 2**32)."""
    x = words - ((words >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return x.sum(dim=-1)


def _join(frequent: List[Itemset]) -> Tuple[np.ndarray, np.ndarray]:
    """Index pairs (a, b), a < b, of sorted frequent (k-1)-itemsets that
    share all but their last item: the level's candidates a ∪ b."""
    left, right = [], []
    start = 0
    for j in range(1, len(frequent) + 1):
        if j == len(frequent) or frequent[j][:-1] != frequent[start][:-1]:
            g = j - start
            if g > 1:
                a, b = np.triu_indices(g, k=1)
                left.append(a + start)
                right.append(b + start)
            start = j
    if not left:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(left), np.concatenate(right)


def mine(db: Sequence[Sequence[int]], n_items: int, min_support: int,
         max_k: int, device: "torch.device | str" = "cpu"
         ) -> Dict[Itemset, int]:
    """Every itemset of at most ``max_k`` items whose support in ``db``
    is at least ``min_support``, with that support."""
    rows = pack(db, n_items, device)
    counts = popcount(rows).tolist()
    frequent = [(i,) for i in range(n_items) if counts[i] >= min_support]
    result: Dict[Itemset, int] = {x: counts[x[0]] for x in frequent}
    bitmaps = rows[[x[0] for x in frequent]]
    del rows
    k = 2
    while len(frequent) > 1 and k <= max_k:
        a, b = _join(frequent)
        block = max(1, BLOCK_WORDS // max(1, bitmaps.shape[1]))
        keep_rows: List[torch.Tensor] = []
        keep: List[Itemset] = []
        for s in range(0, len(a), block):
            ia = torch.from_numpy(a[s:s + block]).to(bitmaps.device)
            ib = torch.from_numpy(b[s:s + block]).to(bitmaps.device)
            joined = bitmaps[ia] & bitmaps[ib]
            sup = popcount(joined)
            hit = torch.nonzero(sup >= min_support).flatten()
            if k < max_k:
                keep_rows.append(joined[hit])
            for j, c in zip(hit.tolist(), sup[hit].tolist()):
                x = frequent[int(a[s + j])] + (frequent[int(b[s + j])][-1],)
                keep.append(x)
                result[x] = c
        # candidates come out grouped by prefix and sorted within a group
        # in both a and b order, so `keep` is in lexicographic order
        frequent = keep
        bitmaps = (torch.cat(keep_rows) if keep_rows
                   else bitmaps[:0])
        k += 1
    return result


def support_of(db_rows: torch.Tensor, itemset: Sequence[int]) -> int:
    """Support of one itemset over packed rows (``pack``'s output)."""
    acc = db_rows[itemset[0]]
    for i in itemset[1:]:
        acc = acc & db_rows[i]
    return int(popcount(acc))
