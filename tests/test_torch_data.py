"""Port vs reference: the synthetic transaction generator and the
candidate machinery (itemsets, buckets, density model) give identical
results on identical inputs."""
import dataclasses
import itertools

import numpy as np
import pytest
from _hyp import given, settings, st

from repro.core import buckets as rb
from repro.core import itemsets as ri
from repro.data import transactions as rt
from repro_torch.core import buckets as tb
from repro_torch.core import itemsets as ti
from repro_torch.data import transactions as tt


# ------------------------------------------------------------------ data
def test_profiles_are_identical():
    assert set(tt.PROFILES) == set(rt.PROFILES)
    for name, p in rt.PROFILES.items():
        assert dataclasses.asdict(tt.PROFILES[name]) == \
            dataclasses.asdict(p), name


@pytest.mark.parametrize("name", sorted(rt.PROFILES))
def test_generator_identical_for_every_profile(name):
    """Each profile's generator, cut to 1,500 transactions (the cut
    changes only the transaction count), gives the same database."""
    rp = dataclasses.replace(rt.PROFILES[name], n_transactions=1500)
    tp = dataclasses.replace(tt.PROFILES[name], n_transactions=1500)
    if rp.kind == "quest":
        assert tt.gen_quest(tp, seed=3) == rt.gen_quest(rp, seed=3)
    else:
        assert tt.gen_dense(tp, seed=3) == rt.gen_dense(rp, seed=3)


@pytest.mark.parametrize("name,scale", [("chess", 1), ("mushroom", 2),
                                        ("t10i4", 1)])
def test_load_identical(name, scale):
    db_t, p_t = tt.load(name, seed=1, scale=scale)
    db_r, p_r = rt.load(name, seed=1, scale=scale)
    assert db_t == db_r
    assert dataclasses.asdict(p_t) == dataclasses.asdict(p_r)
    assert tt.min_support_count(p_t, db_t) == \
        rt.min_support_count(p_r, db_r)


# ------------------------------------------------------------ candidates
def _random_frequent(rng, n_items, k, n):
    sets = {tuple(sorted(rng.choice(n_items, size=k, replace=False)
                         .tolist())) for _ in range(n)}
    return sorted(sets)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_gen_candidates_identical(k):
    rng = np.random.default_rng(k)
    frequent = _random_frequent(rng, 14, k, 60)
    assert ti.gen_candidates(frequent) == ri.gen_candidates(frequent)
    extra = _random_frequent(rng, 14, k, 20)
    assert ti.gen_candidates(frequent, known_frequent=extra) == \
        ri.gen_candidates(frequent, known_frequent=extra)


@settings(max_examples=25, deadline=None, database=None)
@given(st.lists(st.lists(st.integers(0, 11), min_size=3, max_size=3,
                         unique=True), max_size=40))
def test_property_gen_candidates_and_buckets_identical(raw):
    frequent = sorted({tuple(sorted(x)) for x in raw})
    cands = ti.gen_candidates(frequent)
    assert cands == ri.gen_candidates(frequent)
    assert [dataclasses.astuple(b) for b in tb.group_by_prefix(cands)] == \
        [dataclasses.astuple(b) for b in rb.group_by_prefix(cands)]


def _reference_buckets(frequent, known_frequent=()):
    return [dataclasses.astuple(b) for b in rb.group_by_prefix(
        ri.gen_candidates(frequent, known_frequent=known_frequent))]


# frequent pairs whose prune drops (0, 1, 3), as (1, 3) is missing, and
# every extension of the head (0, 2), as (2, 3) is, so (0, 2) gets no
# bucket; (2, 3) as known-frequent gives it its bucket back
_PRUNED = [(0, 1), (0, 2), (0, 3), (1, 2)]


@pytest.mark.parametrize("case", [
    ("random", 2, False), ("random", 2, True),
    ("random", 3, False), ("random", 3, True),
    ("random", 4, False), ("random", 4, True),
    ("pruned", 3, False), ("pruned", 3, True),
    ("empty", 2, False),
])
def test_gen_buckets_equals_grouped_candidates(case):
    """The driver's bucket-direct generator is the reference's
    ``group_by_prefix(gen_candidates(F))``: keys, prefixes and
    extensions, in order, for candidates of size k."""
    kind, k, known = case
    if kind == "random":
        rng = np.random.default_rng(k)
        frequent = _random_frequent(rng, 14, k - 1, 60)
        extra = _random_frequent(rng, 14, k - 1, 20) if known else ()
    elif kind == "pruned":
        frequent, extra = _PRUNED, [(2, 3)] if known else ()
    else:
        frequent, extra = [], ()
    got = [dataclasses.astuple(b)
           for b in tb.gen_buckets(frequent, known_frequent=extra)]
    assert got == _reference_buckets(frequent, extra)
    if kind == "pruned":
        assert [b[1:] for b in got] == (
            [((0, 1), (2,)), ((0, 2), (3,))] if known else [((0, 1), (2,))])


@settings(max_examples=25, deadline=None, database=None)
@given(st.lists(st.lists(st.integers(0, 11), min_size=3, max_size=3,
                         unique=True), max_size=40),
       st.lists(st.lists(st.integers(0, 11), min_size=3, max_size=3,
                         unique=True), max_size=10))
def test_property_gen_buckets_identical(raw, raw_known):
    frequent = sorted({tuple(sorted(x)) for x in raw})
    known = sorted({tuple(sorted(x)) for x in raw_known})
    for extra in ((), known):
        assert [dataclasses.astuple(b) for b in
                tb.gen_buckets(frequent, known_frequent=extra)] == \
            _reference_buckets(frequent, extra)


def test_hashes_and_brute_force_identical():
    rng = np.random.default_rng(0)
    db = [sorted(rng.choice(10, size=rng.integers(1, 6),
                            replace=False).tolist()) for _ in range(60)]
    for it in itertools.combinations(range(6), 3):
        assert ti.prefix_hash(it) == ri.prefix_hash(it)
        assert ti.itemset_hash(it) == ri.itemset_hash(it)
    assert ti.brute_force_frequent(db, 6, max_k=4) == \
        ri.brute_force_frequent(db, 6, max_k=4)


def test_cost_models_identical():
    for args in [(1, 0), (3, 17), (7, 2)]:
        assert tb.bucket_rows_touched(*args) == rb.bucket_rows_touched(*args)
        assert tb.candidate_rows_touched(*args) == \
            rb.candidate_rows_touched(*args)
        assert tb.class_rows_touched(*args) == rb.class_rows_touched(*args)
    assert tb.rows_to_bytes(5, 3125) == rb.rows_to_bytes(5, 3125)


@pytest.mark.parametrize("force", [None, "bitmap", "sparse"])
def test_density_model_picks_identical(force):
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 4000, size=50)
    tm = tb.DensityModel.from_counts(125, counts, force=force)
    rm = rb.DensityModel.from_counts(125, counts, force=force)
    assert tm.ones_per_word == rm.ones_per_word
    for support in [0, 1, 100, 249, 250, 251, 2000, 4000]:
        assert tm.pick_rep(support) == rm.pick_rep(support)
        assert tm.pick_granularity(support) == rm.pick_granularity(support)
        for child in [0, support // 3, support]:
            for diff in (True, False):
                assert tm.pick_child_rep(support, child, diff) == \
                    rm.pick_child_rep(support, child, diff)
    tm.observe([10, 300, 5000])
    rm.observe([10, 300, 5000])
    assert tm.ones_per_word == rm.ones_per_word
    assert (tm.bitmap_picks, tm.tidlist_picks, tm.diffset_picks) == \
        (rm.bitmap_picks, rm.tidlist_picks, rm.diffset_picks)
