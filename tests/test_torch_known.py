"""The streaming layer's bucket-shaped store of known supports
(``repro_torch.core.known``) against a plain dict, and the published
border's immutability through a ``StreamingMiner``.

The property test drives a ``KnownStore`` and a dict through the same
random sequence of reads, writes, copies and a refresh's bulk steps
(classify, fold, threshold, drop of unswept entries, the split at
publish) and requires the same contents after every step, in every
copy, with every stored array read-only. Exact equality throughout:
supports are integers."""
import numpy as np
import pytest
from _hyp import given, settings, st

from repro_torch.core import streaming as ts
from repro_torch.core.buckets import Bucket
from repro_torch.core.fpm import DeltaPlan
from repro_torch.core.itemsets import itemset_hash
from repro_torch.core.known import BorderView, KnownStore

N_ITEMS = 8

itemsets = st.lists(st.integers(0, N_ITEMS - 1), min_size=1, max_size=4,
                    unique=True).map(lambda x: tuple(sorted(x)))
supports = st.integers(0, 60)


def _arrays_read_only(store):
    return all(not e.flags.writeable and not s.flags.writeable
               for _, (e, s) in store._b.items())


def _check(store, want):
    assert len(store) == len(want)
    assert dict(store) == want and store == want
    assert dict(store.items()) == want
    assert sorted(store) == sorted(want)
    assert _arrays_read_only(store)


def _plan(data, want):
    """Prefix buckets with distinct prefixes and sorted extensions, as
    ``gen_buckets`` gives a level's: some of the store's own entries,
    some never counted."""
    old = data.draw(st.lists(st.sampled_from(
        sorted(x for x in want if len(x) >= 2) or [(0, 1)]), max_size=8))
    new = data.draw(st.lists(itemsets.filter(lambda x: len(x) >= 2),
                             max_size=4))
    by_prefix = {}
    for x in old + new:
        by_prefix.setdefault(x[:-1], set()).add(x[-1])
    return [Bucket(itemset_hash(p), p, tuple(sorted(by_prefix[p])))
            for p in sorted(by_prefix)]


def _refresh(data, store, want):
    """One levelwise refresh step on both: classify a random plan, fold
    random counts in, threshold, then drop what went unswept."""
    dirty = data.draw(st.frozensets(st.integers(0, N_ITEMS - 1)))
    plan = _plan(data, want)
    delta = DeltaPlan(known=store, dirty_items=dirty, segments=(1,),
                      base_segments=(0, 1))
    assert delta.known is store
    level, n_clean, d_b, f_b = delta.classify_buckets(plan)
    cands = [b.prefix + (e,) for b in plan for e in b.exts]
    w_fresh = [c for c in cands if c not in want]
    w_dirty = [c for c in cands
               if c in want and all(i in dirty for i in c)]
    assert [b.prefix + (e,) for b in f_b for e in b.exts] == w_fresh
    assert [b.prefix + (e,) for b in d_b for e in b.exts] == w_dirty
    assert n_clean == len(cands) - len(w_fresh) - len(w_dirty)
    swept = []
    for b in f_b + d_b:
        counts = np.array(data.draw(st.lists(
            supports, min_size=len(b.exts), max_size=len(b.exts))))
        is_fresh = b in f_b
        swept.append((b, counts, is_fresh))
        for e, v in zip(b.exts, counts.tolist()):
            c = b.prefix + (e,)
            want[c] = v if is_fresh else want[c] + v
    data.draw(st.randoms()).shuffle(swept)     # the exchange's order
    sups = delta.fold(level, swept)
    ms = data.draw(supports)
    assert delta.threshold(level, sups, ms) == [
        (c, want[c]) for c in cands if want[c] >= ms]
    delta.drop_unswept()
    gone = set(w_fresh) | set(w_dirty)
    for c in [c for c in want if len(c) >= 2 and c not in gone
              and all(i in dirty for i in c)]:
        del want[c]


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_property_store_equals_dict_through_every_operation(data):
    first = data.draw(st.dictionaries(itemsets, supports, max_size=12))
    pairs = [(KnownStore(first), dict(first))]
    borders = []            # (view, its contents when split off)
    for _ in range(data.draw(st.integers(1, 14))):
        i = data.draw(st.integers(0, len(pairs) - 1))
        store, want = pairs[i]
        op = data.draw(st.sampled_from(
            ["get", "set", "update", "pop", "copy", "refresh", "split"]))
        if op == "get":
            x = data.draw(itemsets)
            assert store.get(x) == want.get(x)
            assert (x in store) == (x in want)
        elif op == "set":
            x, s = data.draw(itemsets), data.draw(supports)
            store[x] = want[x] = s
        elif op == "update":
            upd = data.draw(st.lists(st.tuples(itemsets, supports),
                                     max_size=6))
            store.update(upd)
            want.update(upd)
        elif op == "pop":
            x = data.draw(itemsets)
            assert store.pop(x, None) == want.pop(x, None)
        elif op == "copy":
            # a split: both go on, each a store of its own
            pairs.append((store.copy(), dict(want)))
        elif op == "refresh":
            _refresh(data, store, want)
        else:
            ms, max_len = data.draw(supports), data.draw(st.integers(1, 4))
            frequent, border = store.split(ms, max_len)
            short = {x: s for x, s in want.items() if len(x) <= max_len}
            assert dict(frequent) == {x: s for x, s in short.items()
                                      if s >= ms}
            rest = {x: s for x, s in short.items() if s < ms}
            assert isinstance(border, BorderView)
            assert dict(border) == rest and len(border) == len(rest)
            for x in list(want)[:4]:
                assert border.get(x) == rest.get(x)
            borders.append((border, rest))
        for s_, w_ in pairs:
            _check(s_, w_)
        for view, was in borders:
            assert dict(view) == was


def test_delta_plan_takes_a_mapping_and_keeps_dict_semantics():
    plan = DeltaPlan(known={(1, 2): 5, (1, 3): 2, (2, 3): 7},
                     dirty_items=frozenset({1, 2}), segments=(1,),
                     base_segments=(0, 1))
    assert isinstance(plan.known, KnownStore)
    assert plan.known == {(1, 2): 5, (1, 3): 2, (2, 3): 7}
    with pytest.raises(KeyError):
        plan.known[(1, 4)]
    with pytest.raises(KeyError):
        plan.known[()]
    _, sups = plan.known._b[(1,)]
    with pytest.raises(ValueError):
        sups[0] = 0                   # stored arrays are read-only


def rand_db(n, items=16, seed=7):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(items, size=rng.integers(2, 7),
                              replace=False).tolist())
            for _ in range(n)]


def test_published_border_survives_next_refresh_and_query_backfill():
    """Copy-on-write: generation g's border, held by a reader, is the
    same after refresh g+1 and after a query backfill into generation
    g+1's store; so is generation g+1's."""
    db = rand_db(420)
    sm = ts.StreamingMiner(16, 0.1, initial_db=db[:300], device="cpu",
                           backend="torch", n_workers=2, max_k=4)
    try:
        sm.refresh()
        snap = sm.snapshot
        assert isinstance(snap.border, BorderView)
        border = dict(snap.border)
        assert border
        sm.ingest(db[300:])
        sm.refresh()
        snap2 = sm.snapshot
        border2 = dict(snap2.border)
        assert border2 != border          # the supports moved
        assert dict(snap.border) == border
        counted = set(snap2.supports) | set(border2)
        never = [x for x in ((0, 1, 2, 3), (4, 5, 6, 7), (1, 3, 5, 7),
                             (2, 4, 6, 8), (0, 5, 10, 15))
                 if x not in counted]
        assert never
        sm.support_many(never)
        assert all(x in sm._known for x in never)
        assert dict(snap.border) == border
        assert dict(snap2.border) == border2
        for x, s in border.items():
            assert snap.lookup(x) == (s, True)
            assert snap.support(x, include_infrequent=True) == s
        assert _arrays_read_only(sm._known)
    finally:
        sm.close()
