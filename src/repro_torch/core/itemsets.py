"""Apriori itemset machinery: candidate generation, prefix clustering.

Itemsets are sorted tuples of item ids. The paper clusters k-itemset tasks
by their (k-1)-prefix via XOR of per-item hashes (Section 4); we reproduce
that hash exactly (std::hash of an integer is the identity in libstdc++ —
we use a mixing hash to avoid degenerate buckets, but keep the XOR
combiner).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

Itemset = Tuple[int, ...]


def _mix(x: int) -> int:
    """64-bit integer mixing hash (splitmix64 finalizer)."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def itemset_hash(items: Iterable[int]) -> int:
    """XOR of per-item mixing hashes — the paper's §4 combiner. Used
    directly by the depth-first engine to key an equivalence class by
    its full prefix."""
    h = 0
    for item in items:
        h ^= _mix(item)
    return h


def prefix_hash(itemset: Itemset) -> int:
    """Paper §4: XOR of per-item hashes over the first (k-1) items —
    itemsets sharing a (k-1)-prefix land in the same bucket."""
    return itemset_hash(itemset[:-1])


def prefix_of(itemset: Itemset) -> Itemset:
    return itemset[:-1]


def gen_candidates(frequent: Sequence[Itemset],
                   known_frequent: Iterable[Itemset] = ()) -> List[Itemset]:
    """F_{k-1} -> C_k by prefix join + anti-monotone prune (Apriori).

    ``known_frequent`` widens the prune set beyond the join frontier:
    granularity="auto" detaches whole subtrees to depth-first class
    tasks, so their itemsets never re-enter ``frequent`` — without the
    full known-frequent membership, a candidate whose (k-1)-subset was
    mined inside a detached subtree would be falsely pruned."""
    fset = set(frequent)
    fset.update(known_frequent)
    if not frequent:
        return []
    k = len(frequent[0]) + 1
    # group by (k-2)-prefix; join pairs within a group
    by_prefix: Dict[Itemset, List[int]] = {}
    for it in frequent:
        by_prefix.setdefault(it[:-1], []).append(it[-1])
    out: List[Itemset] = []
    for pref, lasts in by_prefix.items():
        lasts.sort()
        for i, a in enumerate(lasts):
            for b in lasts[i + 1:]:
                cand = pref + (a, b)
                # prune: every (k-1)-subset must be frequent
                if k <= 2 or all(
                        cand[:j] + cand[j + 1:] in fset
                        for j in range(k)):
                    out.append(cand)
    return out


def brute_force_frequent(db: Sequence[Sequence[int]], min_support: int,
                         max_k: int = 6) -> Dict[Itemset, int]:
    """Oracle for tests: enumerate all itemsets by breadth-first Apriori
    over explicit set intersections (no bitmaps, no scheduler)."""
    from itertools import combinations
    tidsets: Dict[int, set] = {}
    for t, txn in enumerate(db):
        for i in set(txn):
            tidsets.setdefault(i, set()).add(t)
    result: Dict[Itemset, int] = {}
    frequent = []
    for i, tids in sorted(tidsets.items()):
        if len(tids) >= min_support:
            result[(i,)] = len(tids)
            frequent.append((i,))
    k = 2
    while frequent and k <= max_k:
        cands = gen_candidates(frequent)
        frequent = []
        for c in cands:
            tids = tidsets[c[0]]
            for i in c[1:]:
                tids = tids & tidsets[i]
            if len(tids) >= min_support:
                result[c] = len(tids)
                frequent.append(c)
        k += 1
    return result
