"""IBM Quest market-basket generator (Agrawal & Srikant, VLDB'94), frozen.

The benchmark makes its data here, not through the program, so that no
later change to the program can change what is measured. The draws are
those of ``repro_torch.data.transactions.gen_quest`` at the same
parameters and seed, bit for bit (``tests/test_perfbench_data.py``
holds the two against each other): L maximal patterns with geometric
sizes over Zipf-weighted items, then each transaction composed of
corrupted copies of patterns drawn by exponential weights, with an
occasional noise item. A weighted ``Generator.choice`` with
replacement draws one uniform double and searches the weights' CDF;
this copy does the same with the CDF built once, which is what makes
it several times faster than calling ``choice`` per draw.
"""
from __future__ import annotations

from typing import List

import numpy as np


def gen_quest(n_transactions: int, n_items: int, avg_len: int,
              avg_pattern: int, n_patterns: int, zipf: float,
              seed: int) -> List[List[int]]:
    """``n_transactions`` sorted item lists over ``range(n_items)``:
    T = ``avg_len``, I = ``avg_pattern``, L = ``n_patterns``."""
    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, n_items + 1) ** zipf
    weights /= weights.sum()
    patterns = []
    for _ in range(n_patterns):
        size = max(1, int(rng.geometric(1.0 / avg_pattern)))
        patterns.append(np.unique(
            rng.choice(n_items, size=min(size, n_items), p=weights,
                       replace=False)))
    pat_weights = rng.exponential(size=n_patterns)
    pat_weights /= pat_weights.sum()
    corruption = rng.uniform(0.2, 0.8, size=n_patterns)
    # Generator.choice(n, p=w) with replacement and no size:
    # cdf = w.cumsum(); cdf /= cdf[-1]; cdf.searchsorted(random(), "right")
    pat_cdf = pat_weights.cumsum()
    pat_cdf /= pat_cdf[-1]
    item_cdf = weights.cumsum()
    item_cdf /= item_cdf[-1]
    half_corruption = corruption * 0.5
    pattern_lists = [p.tolist() for p in patterns]
    random, poisson = rng.random, rng.poisson
    pick_pattern, pick_item = pat_cdf.searchsorted, item_cdf.searchsorted
    cap = 3 * avg_len
    db = []
    for _ in range(n_transactions):
        target = max(1, int(poisson(avg_len)))
        txn: set = set()
        while len(txn) < target:
            pi = int(pick_pattern(random(), side="right"))
            pat = patterns[pi]
            keep = random(len(pat)) > half_corruption[pi]
            if keep.all():
                txn.update(pattern_lists[pi])
            else:
                txn.update(pat[keep].tolist())
            if random() < 0.1:
                txn.add(int(pick_item(random(), side="right")))
            if len(pat) == 0:
                break
        db.append(sorted(txn)[:cap])
    return db
