"""Synthetic transaction databases (FIMI analogues — DESIGN.md §7.1).

The FIMI repository datasets are not redistributable offline, so we
implement the IBM Quest generator (Agrawal & Srikant, VLDB'94 — the
generator behind T10I4D100K / T40I10D100K) plus dense-profile generators
matching the density character of chess / connect / mushroom / pumsb.

Each profile returns (db, n_items) with db = list of item-id lists, and a
``support`` fraction mirroring Table 1's per-dataset support column.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Profile:
    name: str
    support: float          # min-support fraction (paper Table 1 analogue)
    kind: str               # 'quest' | 'dense'
    n_transactions: int = 10000
    n_items: int = 200
    avg_len: int = 10       # quest: mean transaction length (T)
    avg_pattern: int = 4    # quest: mean maximal-pattern length (I)
    n_patterns: int = 100   # quest: number of maximal patterns (L)
    density: float = 0.35   # dense: per-item probability
    n_dense_items: int = 40
    zipf: float = 0.75      # quest: item-popularity skew exponent


PROFILES: Dict[str, Profile] = {
    # quest-parameterized sparse market-basket data (T10I4 / T40I10)
    "t10i4":   Profile("t10i4", 0.005, "quest", 20000, 500, 10, 4, 200),
    "t40i10":  Profile("t40i10", 0.02, "quest", 8000, 500, 40, 10, 200),
    "kosarak": Profile("kosarak", 0.006, "quest", 20000, 800, 8, 4, 400),
    # retail-like sparse long tail: many items, steep Zipf skew, long
    # correlated patterns at low support — frequent itemsets form deep,
    # NARROW equivalence classes (few siblings per prefix). This is the
    # stress regime for the depth-first engine's memory bound and
    # barrier-freedom (a level-synchronous driver barriers on a handful
    # of live branches), and also where Eclat's unpruned class-local
    # sweeps cost the most vs Apriori — the benchmark records both.
    "retail":  Profile("retail", 0.012, "quest", 12000, 1200, 12, 5, 500,
                       zipf=1.05),
    # dense UCI-style datasets (high support thresholds, like the paper)
    "chess":      Profile("chess", 0.60, "dense", 3196, 75,
                          density=0.49, n_dense_items=75),
    "connect":    Profile("connect", 0.82, "dense", 6000, 90,
                          density=0.47, n_dense_items=90),
    "mushroom":   Profile("mushroom", 0.20, "dense", 8124, 100,
                          density=0.22, n_dense_items=100),
    "pumsb":      Profile("pumsb", 0.80, "dense", 8000, 120,
                          density=0.55, n_dense_items=120),
    "accidents":  Profile("accidents", 0.35, "dense", 10000, 150,
                          density=0.30, n_dense_items=150),
}


def gen_quest(p: Profile, seed: int = 0) -> List[List[int]]:
    """IBM Quest: build L maximal patterns (item subsets with geometric
    sizes), then compose each transaction from overlapping patterns."""
    rng = np.random.default_rng(seed)
    # pattern item pools are Zipf-weighted so some items are very
    # frequent; ``p.zipf`` sets the skew (retail-like long tails ~1.05)
    weights = 1.0 / np.arange(1, p.n_items + 1) ** p.zipf
    weights /= weights.sum()
    patterns = []
    for _ in range(p.n_patterns):
        size = max(1, int(rng.geometric(1.0 / p.avg_pattern)))
        patterns.append(np.unique(
            rng.choice(p.n_items, size=min(size, p.n_items), p=weights,
                       replace=False)))
    pat_weights = rng.exponential(size=p.n_patterns)
    pat_weights /= pat_weights.sum()
    corruption = rng.uniform(0.2, 0.8, size=p.n_patterns)
    db = []
    for _ in range(p.n_transactions):
        target = max(1, int(rng.poisson(p.avg_len)))
        txn: set = set()
        while len(txn) < target:
            pi = rng.choice(p.n_patterns, p=pat_weights)
            pat = patterns[pi]
            keep = rng.random(len(pat)) > corruption[pi] * 0.5
            txn.update(pat[keep].tolist())
            if rng.random() < 0.1:              # occasional noise item
                txn.add(int(rng.choice(p.n_items, p=weights)))
            if len(patterns[pi]) == 0:
                break
        db.append(sorted(txn)[:3 * p.avg_len])
    return db


def gen_dense(p: Profile, seed: int = 0) -> List[List[int]]:
    """Dense UCI-style data: correlated blocks of frequently-co-occurring
    items (chess/connect-like), giving deep frequent itemsets."""
    rng = np.random.default_rng(seed)
    n, m = p.n_transactions, p.n_dense_items
    # correlated latent factors -> co-occurrence structure
    n_factors = max(4, m // 12)
    loadings = rng.random((n_factors, m)) < 0.35
    base = rng.random(m) * p.density * 1.4
    db = []
    factors = rng.random((n, n_factors)) < 0.5
    noise = rng.random((n, m))
    for t in range(n):
        active = noise[t] < base
        for f in np.nonzero(factors[t])[0]:
            active |= loadings[f] & (noise[t] < p.density * 2.2)
        items = np.nonzero(active)[0]
        if len(items) == 0:
            items = rng.choice(m, size=2, replace=False)
        db.append(items.tolist())
    return db


def load(profile: str, seed: int = 0,
         scale: int = 1) -> Tuple[List[List[int]], Profile]:
    """``scale`` multiplies n_transactions — the paper's datasets have
    10^5..10^6 transactions, where the per-task TID-join dominates
    scheduling overhead; benchmarks use scale>1 to match that regime
    (tests use scale=1 for speed)."""
    p = PROFILES[profile]
    if scale != 1:
        p = dataclasses.replace(p,
                                n_transactions=p.n_transactions * scale)
    db = gen_quest(p, seed) if p.kind == "quest" else gen_dense(p, seed)
    return db, p


def min_support_count(p: Profile, db) -> int:
    return max(1, int(p.support * len(db)))
