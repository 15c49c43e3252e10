"""The benchmark's frozen generator and its plain reference miner."""
from __future__ import annotations

import dataclasses
import itertools
from collections import Counter

import pytest
import torch

from perfbench.data.quest import gen_quest
from perfbench.reference import miner as ref


@pytest.mark.parametrize("profile", ["t10i4", "retail"])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345])
def test_quest_matches_program_generator_bit_for_bit(profile, seed):
    # the program is imported only to compare against
    from repro_torch.data.transactions import PROFILES
    from repro_torch.data.transactions import gen_quest as program_gen
    p = dataclasses.replace(PROFILES[profile], n_transactions=1200)
    want = program_gen(p, seed)
    got = gen_quest(p.n_transactions, p.n_items, p.avg_len, p.avg_pattern,
                    p.n_patterns, p.zipf, seed)
    assert got == want


def test_receipts_are_cached_and_seeds_reorder_them(tmp_path, monkeypatch):
    from perfbench import workload
    monkeypatch.setattr(workload, "CACHE", tmp_path)
    config = {"name": "t", "data_seed": 4, "n_items": 300, "avg_len": 8,
              "avg_pattern": 4, "n_patterns": 60, "zipf": 0.9}
    db = workload.receipts(config, 500)
    assert db == gen_quest(500, 300, 8, 4, 60, 0.9, 4)
    assert len(list(tmp_path.glob("t-*.npz"))) == 1
    assert workload.receipts(config, 500) == db       # from the cache
    a = workload.shuffled(db, 11, [0, 400, 500])
    assert a == workload.shuffled(db, 11, [0, 400, 500])
    assert a != workload.shuffled(db, 12, [0, 400, 500])
    # each block keeps its receipts
    key = [tuple(t) for t in db]
    assert sorted(map(tuple, a[:400])) == sorted(key[:400])
    assert sorted(map(tuple, a[400:])) == sorted(key[400:])


def brute_force(db, min_support, max_k):
    counts = Counter()
    for t in db:
        for k in range(1, max_k + 1):
            counts.update(itertools.combinations(sorted(t), k))
    return {x: c for x, c in counts.items() if c >= min_support}


@pytest.mark.parametrize("seed,max_k,support", [(1, 3, 0.03), (2, 4, 0.02),
                                                (3, 6, 0.05)])
def test_reference_mine_equals_brute_force(seed, max_k, support):
    db = gen_quest(300, 60, 6, 3, 20, 0.9, seed)
    ms = ref.min_support_count(support, len(db))
    assert ref.mine(db, 60, ms, max_k) == brute_force(db, ms, max_k)


def test_reference_pack_and_support_of_count_every_receipt():
    db = [[0, 3], [3], [1, 3, 4], [], [0, 1, 3]] * 9   # 45 receipts, 2 words
    rows = ref.pack(db, 5, "cpu")
    assert rows.shape == (5, 2)
    assert ref.popcount(rows).tolist() == [18, 18, 0, 36, 9]
    assert ref.support_of(rows, (0, 3)) == 18
    assert ref.support_of(rows, (1, 3, 4)) == 9
    words = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000001], dtype=torch.int64)
    assert ref.popcount(words[:, None]).tolist() == [0, 1, 32, 2]


def test_min_support_count_floors_the_fraction():
    assert ref.min_support_count(0.005, 100_000) == 500
    assert ref.min_support_count(0.005, 88_162) == 440
    assert ref.min_support_count(0.001, 10) == 1
