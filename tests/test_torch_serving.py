"""The port's query serving against the reference's and against brute
force on the same seeded databases (``device="cpu"``): query and
candidate sweeps sharing one dispatcher flush, the priority window,
unknown-itemset sweeps, snapshot consistency across a publish, the
backfill, the negative border, host and device top-k (tie-heavy cases
included), and per-kind server counters.

The two multi-tenant cases of ``tests/test_serving.py`` are ported in
``tests/test_torch_tenants.py``."""
import itertools
import threading

import numpy as np
import pytest
import torch
from _hyp import given, settings, st

import repro.core.streaming as rstreaming
import repro_torch.core.streaming as tstreaming
from repro.core.fpm import mine as rmine
from repro.core.tidlist import pack_database as rpack
from repro_torch.core.join_backend import SweepDispatcher, TorchBackend
from repro_torch.core.streaming import (PatternServer, PatternSnapshot,
                                        StreamingMiner)
from repro_torch.core.tidlist import BitmapArena, pack_database


def rand_db(n, items=12, seed=7):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(items, size=rng.integers(2, 6),
                              replace=False).tolist())
            for _ in range(n)]


def brute(db, itemset):
    want = set(itemset)
    return sum(1 for t in db if want <= set(t))


def port_miner(n_items, ms, **kw):
    return StreamingMiner(n_items, ms, device="cpu", **kw)


# ------------------------------------------------- dispatcher coalescing
def test_query_and_candidate_sweeps_share_one_flush():
    """A candidate sweep and a priority query sweep (a prefix tuple)
    pending on one dispatcher drain in ONE flush: the flush threshold is
    2 and the straggler window far beyond the test, so both futures
    resolve only through the shared batch."""
    db = rand_db(64, items=8, seed=3)
    arena = BitmapArena.from_bitmaps(pack_database(db, 8), device="cpu")
    disp = SweepDispatcher(arena, TorchBackend(), n_clients=2,
                           flush_us=5_000_000.0,
                           query_flush_us=5_000_000.0)
    try:
        f_cand = disp.submit(0, (1,))                       # candidate
        f_query = disp.submit((2, 3), (4,), priority=True)  # query
        assert int(f_cand.result(timeout=10)[0]) == brute(db, (0, 1))
        assert int(f_query.result(timeout=10)[0]) == brute(db, (2, 3, 4))
        assert disp.queue_flushes == 1
        assert disp.queue_requests == 2
        assert disp.query_requests == 1
        assert disp.stats()["query_requests"] == 1
    finally:
        disp.stop()


def test_priority_query_flushes_within_query_window():
    """A lone query does not sit out the full straggler window."""
    db = rand_db(32, items=6, seed=4)
    arena = BitmapArena.from_bitmaps(pack_database(db, 6), device="cpu")
    disp = SweepDispatcher(arena, TorchBackend(), n_clients=8,
                           flush_us=5_000_000.0, query_flush_us=1000.0)
    try:
        got = disp.submit(0, (1,), priority=True).result(timeout=2)
        assert int(got[0]) == brute(db, (0, 1))
    finally:
        disp.stop()


# ------------------------------------------------- exactness (sweeps)
@settings(max_examples=12, deadline=None)
@given(st.data())
def test_unknown_itemset_sweeps_match_brute_force(data):
    """support_many answers ARBITRARY itemsets exactly, as the
    reference does."""
    n_items = 10
    db = data.draw(st.lists(
        st.lists(st.integers(0, n_items - 1), min_size=1, max_size=6,
                 unique=True),
        min_size=5, max_size=60))
    ms = data.draw(st.integers(1, max(1, len(db) // 2)))
    probes = data.draw(st.lists(
        st.lists(st.integers(0, n_items - 1), min_size=0, max_size=5,
                 unique=True),
        min_size=1, max_size=8))
    sm = port_miner(n_items, ms, initial_db=db, n_workers=2, max_k=3)
    try:
        sm.refresh()
        got = sm.support_many(probes)
        assert got == [brute(db, x) if x else len(db) for x in probes]
        assert sm.support_many(probes) == got       # now mostly dict hits
    finally:
        sm.close()


def test_query_sweeps_bill_like_reference():
    """The same probes over the same generation: the same answers, the
    same sweep count and swept bytes as the reference, on a two-segment
    arena (the sweeps AND their prefix tuples per segment)."""
    full = rand_db(240, items=12, seed=8)
    probes = [(0, 1, 2, 3, 4), (3, 4, 9), (1, 5), (2,), (), (6, 7, 8, 10)]
    out = []
    for sm in (port_miner(12, 10_000, initial_db=full[:200], n_workers=2,
                          max_k=2, compact_ratio=0.0),
               rstreaming.StreamingMiner(12, 10_000, initial_db=full[:200],
                                         n_workers=2, max_k=2,
                                         backend="numpy",
                                         compact_ratio=0.0)):
        try:
            sm.refresh()
            sm.ingest(full[200:])
            sm.refresh()
            out.append((sm.support_many(probes), sm.query_sweeps,
                        sm.query_sweep_bytes, sm.arena.n_segments))
        finally:
            sm.close()
    assert out[0] == out[1]
    assert out[0][0] == [brute(full, x) if x else 240 for x in probes]
    assert out[0][1] > 0 and out[0][3] == 2


def test_support_many_is_snapshot_consistent_across_publish():
    """A query batch fired mid-refresh (pre-swap) answers entirely from
    the old generation; after the swap, over the whole database."""
    full = rand_db(300, items=12, seed=5)
    sm = port_miner(12, 25, initial_db=full[:200], n_workers=2, max_k=4)
    try:
        sm.refresh()
        sm.ingest(full[200:])
        probes = [(0, 1, 2, 3, 4), (3, 4), (1, 5, 7), (2,), ()]
        want_old = [brute(full[:200], x) if x else 200 for x in probes]
        want_new = [brute(full, x) if x else 300 for x in probes]
        seen = {}

        def hook(snapshot):
            seen["mid"] = sm.support_many(probes)

        sm.refresh(before_publish=hook)
        assert seen["mid"] == want_old
        assert sm.support_many(probes) == want_new
    finally:
        sm.close()


def test_query_backfill_repeat_hits_and_survives_refresh():
    """An answered query backfills the known store (a repeat is a dict
    hit), and a later ingest touching its items re-sweeps it."""
    full = rand_db(260, items=10, seed=11)
    sm = port_miner(10, 10_000, initial_db=full[:200], n_workers=2,
                    max_k=2)
    srv = PatternServer(sm)
    probe = (0, 1, 2)
    try:
        sm.refresh()
        assert srv.support(probe) == brute(full[:200], probe)
        assert srv.merged_stats()["sweep"] == 1
        assert srv.support(probe) == brute(full[:200], probe)
        stats = srv.merged_stats()
        assert stats["sweep"] == 1 and stats["hit"] == 1
        sm.ingest(full[200:])
        sm.refresh()
        assert srv.support(probe) == brute(full, probe)
        assert srv.merged_stats()["sweep"] == 2
    finally:
        sm.close()


# ------------------------------------------------- negative border
def test_negative_border_published_and_served():
    db = [[0, 1]] * 3 + [[0]] * 10 + [[1]] * 10 + [[2, 3]] * 12
    sm = port_miner(4, 5, initial_db=db, n_workers=2, max_k=3)
    ref = rstreaming.StreamingMiner(4, 5, initial_db=db, n_workers=2,
                                    max_k=3, backend="numpy")
    try:
        sm.refresh()
        ref.refresh()
        snap = sm.snapshot
        assert dict(snap.border) == dict(ref.snapshot.border)
        assert snap.support((0, 1)) is None
        assert snap.support((0, 1), include_infrequent=True) == 3
        assert snap.lookup((0, 1)) == (3, True)
        assert snap.lookup((2, 3)) == (12, False)
        assert snap.lookup((0, 2))[1] is True       # support 0, counted
        srv = PatternServer(sm)
        assert srv.support((0, 1)) == 3             # border == dict hit
        assert srv.merged_stats()["sweep"] == 0
    finally:
        sm.close()
        ref.close()


# ------------------------------------------------- device-resident top-k
def _reference_top_k(supports, prefix, k):
    """The documented ordering the slow way: strict extensions of
    prefix, support descending, lexicographic ties."""
    prefix = tuple(sorted(prefix))
    rows = [(x, s) for x, s in supports.items()
            if len(x) > len(prefix) and x[:len(prefix)] == prefix]
    return [(x, -ns) for ns, x in sorted((-s, x) for x, s in rows)[:k]]


def _tie_heavy_supports():
    rng = np.random.default_rng(0)
    supports = {}
    for i in range(20):
        supports[(i,)] = 50 + int(rng.integers(0, 4))
    for i, j in itertools.combinations(range(12), 2):
        supports[(i, j)] = 10 + (i + j) % 5          # dense tie bands
    for x in [(0, 1, 2), (0, 1, 3), (0, 2, 5), (1, 2, 3), (2, 3, 4)]:
        supports[x] = 7
    return supports


@pytest.mark.parametrize("prefix,k", [
    ((), 10), ((), 1000), ((0,), 4), ((1,), 1), ((0, 1), 5),
    ((0, 1, 2), 3), ((9, 10, 11, 12), 2), ((), 0),
])
def test_top_k_host_and_device_paths_match_reference(monkeypatch,
                                                     prefix, k):
    """Host and device rankings are identical to each other, to the
    documented order and to the reference's, on tie-heavy supports."""
    supports = _tie_heavy_supports()
    want = _reference_top_k(supports, prefix, k)
    host = PatternSnapshot(1, 100, 2, supports, device="cpu").top_k(
        prefix, k)
    assert host == want
    assert rstreaming.PatternSnapshot(1, 100, 2, supports).top_k(
        prefix, k) == want
    monkeypatch.setattr(tstreaming, "TOPK_DEVICE_MIN", 0)
    calls = []
    orig = tstreaming._SnapshotIndex._device_top_k

    def spy(self, *a):
        calls.append(a)
        return orig(self, *a)
    monkeypatch.setattr(tstreaming._SnapshotIndex, "_device_top_k", spy)
    dev = PatternSnapshot(1, 100, 2, supports, device="cpu").top_k(
        prefix, k)
    assert dev == want
    assert len(calls) == (1 if k > 0 and len(prefix) < 3 else 0)


def test_top_k_device_path_on_miner(monkeypatch):
    monkeypatch.setattr(tstreaming, "TOPK_DEVICE_MIN", 0)
    db = rand_db(200, items=10, seed=13)
    sm = port_miner(10, 20, initial_db=db, n_workers=2, max_k=4)
    try:
        sm.refresh()
        supports = dict(sm.snapshot.supports)
        for prefix in [(), (0,), (1, 3)]:
            assert sm.snapshot.top_k(prefix, 7) == _reference_top_k(
                supports, prefix, 7)
    finally:
        sm.close()


def test_device_top_k_without_device_raises_when_no_cuda(monkeypatch):
    """A snapshot left on the default device ranks on the card: without
    one the device path raises, it does not fall back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tstreaming, "TOPK_DEVICE_MIN", 0)
    snap = PatternSnapshot(1, 10, 1, {(0,): 3, (1,): 2})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        snap.top_k((), 1)
    monkeypatch.setattr(tstreaming, "TOPK_DEVICE_MIN", 4096)
    assert snap.top_k((), 1) == [((0,), 3)]    # small: the host policy


# ------------------------------------------------- server counters
def test_server_counts_queries_per_kind_thread_safe():
    db = rand_db(150, items=8, seed=17)
    sm = port_miner(8, 15, initial_db=db, n_workers=2, max_k=3)
    sm.refresh()
    srv = PatternServer(sm)
    hot = next(iter(sm.snapshot.supports))
    per_thread = 50

    def hammer():
        for _ in range(per_thread):
            srv.support(hot)
            srv.top_k((), 3)
            srv.frequent()

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        stats = srv.merged_stats()
        # support(known) + frequent() count as hits; no lost updates
        assert stats["hit"] == 2 * 8 * per_thread
        assert stats["top_k"] == 8 * per_thread
        assert stats["sweep"] == 0
        assert srv.queries == stats["queries"] == 3 * 8 * per_thread
        assert set(srv.latency_percentiles()) >= {"hit", "top_k"}
    finally:
        sm.close()


def test_served_supports_match_reference_miner_and_batch_mine():
    """Per-kind answers of the port's server equal the reference
    server's for the same generation: hits, sweeps and top-k."""
    db = rand_db(300, items=12, seed=19)
    probes = [(0, 1), (2, 3, 4), (0, 1, 2, 3, 4, 5), (7, 11), (5,)]
    sm = port_miner(12, 20, initial_db=db, n_workers=2, max_k=3)
    ref = rstreaming.StreamingMiner(12, 20, initial_db=db, n_workers=2,
                                    max_k=3, backend="numpy")
    try:
        sm.refresh()
        ref.refresh()
        srv, rsrv = PatternServer(sm), rstreaming.PatternServer(ref)
        assert srv.support_many(probes) == rsrv.support_many(probes)
        assert srv.merged_stats() == rsrv.merged_stats()
        assert srv.top_k((0,), 4) == rsrv.top_k((0,), 4)
        assert dict(sm.snapshot.supports) == rmine(
            rpack(db, 12), 20, max_k=3, backend="numpy")[0]
    finally:
        sm.close()
        ref.close()
