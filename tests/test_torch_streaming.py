"""The port's streaming miner against the reference's on the same seeded
databases (``device="cpu"``): exact supports at every generation for
every granularity, the deterministic gauges of a one-worker schedule,
border classification, incremental-work bounds, snapshot atomicity,
failed-refresh retry, segment compaction and ingest overlapping a
refresh.

Not ported from ``tests/test_streaming.py``: the logical-mesh cases
(they wait for the port's multi-device slice) and the jit-cache bound
(the port has no jit cache)."""
import threading

import numpy as np
import pytest
from _hyp import given, settings, st

from repro.core import fpm as rfpm
from repro.core import streaming as rs
from repro.core.fpm import mine as rmine
from repro.core.itemsets import brute_force_frequent
from repro.core.tidlist import pack_database as rpack
from repro.data.transactions import load
from repro_torch.core import fpm as tfpm
from repro_torch.core import streaming as ts
from repro_torch.core.join_backend import NumpyBackend


def rand_db(n, items=16, seed=7):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(items, size=rng.integers(2, 7),
                              replace=False).tolist())
            for _ in range(n)]


def batch_mine(db, n_items, ms, **kw):
    """The reference's batch mine: the oracle of every generation."""
    return rmine(rpack(db, n_items), ms, backend="numpy", **kw)[0]


def port_miner(n_items, ms, **kw):
    kw.setdefault("backend", "torch")
    return ts.StreamingMiner(n_items, ms, device="cpu", **kw)


# ------------------------------------------------- equivalence matrix
@pytest.mark.parametrize("granularity,policy", [
    ("bucket", "clustered"), ("bucket", "nn"),
    ("depth-first", "clustered"), ("depth-first", "nn"),
    ("candidate", "clustered"), ("bucket", "fifo"),
    ("auto", "clustered"),
])
def test_refresh_matches_batch_mine(granularity, policy):
    """After every ingest, refresh() equals a from-scratch mine of the
    concatenated database — and the reference's streaming miner."""
    full = rand_db(400)
    cuts = [250, 320, 360, 400]
    ms = 40
    kw = dict(granularity=granularity, policy=policy, n_workers=3,
              max_k=5)
    sm = port_miner(16, ms, initial_db=full[:cuts[0]], **kw)
    ref = rs.StreamingMiner(16, ms, initial_db=full[:cuts[0]],
                            backend="numpy", **kw)
    try:
        prev_cut = cuts[0]
        for cut in cuts:
            if cut != prev_cut:
                sm.ingest(full[prev_cut:cut])
                ref.ingest(full[prev_cut:cut])
                prev_cut = cut
            rep, rrep = sm.refresh(), ref.refresh()
            want = batch_mine(full[:cut], 16, ms, max_k=5)
            assert dict(sm.snapshot.supports) == want
            assert dict(sm.snapshot.border) == dict(ref.snapshot.border)
            assert rep.frequent == rrep.frequent == len(want)
            assert (rep.reused, rep.swept_delta, rep.swept_full) == (
                rrep.reused, rrep.swept_delta, rrep.swept_full)
            assert sm.snapshot.n_transactions == cut
    finally:
        sm.close()
        ref.close()


def zipf_db(n, items=60, seed=1):
    """Skewed item frequencies: frequent heads and a long tail, so some
    prefixes are sparse enough for tid-list rows, and a small batch
    leaves many items clean."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, items + 1) ** 1.1
    return [sorted(rng.choice(items, size=rng.integers(2, 7),
                              replace=False, p=p / p.sum()).tolist())
            for _ in range(n)]


def _gated_roots(spawn_roots):
    """``_ClassMiner.spawn_roots`` with the one worker held in a gate
    task until every root class is queued. Otherwise the worker starts
    on the first root while the driver is still spawning the rest, and
    which root it takes next (so which rows are live at each mirror sync,
    and the arena's row high-water mark) depends on the thread timing."""
    def gated(self, frequent, result):
        entered, release = threading.Event(), threading.Event()

        def gate():
            entered.set()
            release.wait()

        self.sched.spawn(gate, attr=(0, ()), worker=0)
        assert entered.wait(60), "the worker never took the gate task"
        try:
            spawn_roots(self, frequent, result)
        finally:
            release.set()
    return gated


GAUGES = ("rows_touched", "bytes_swept", "h2d_bytes", "compacted_segments",
          "reused", "swept_delta", "swept_full", "stayed", "born", "died",
          "dirty_items", "frequent", "segments_refreshed")


@pytest.mark.parametrize("granularity,arena", [
    ("bucket", "auto"), ("candidate", "auto"), ("depth-first", "auto"),
    ("auto", "auto"), ("bucket", "jax"), ("depth-first", "jax")])
def test_one_worker_gauges_equal_reference(granularity, arena,
                                          monkeypatch):
    """One worker fixes the schedule, so the deterministic gauges of
    every ingest and refresh — rows and bytes touched, h2d per ingest
    and per refresh, the plan's reuse counters, compaction — equal the
    reference's kernel-backend run, with tid-list prefixes (sparse
    sweeps) in the refreshes.

    The depth-first driver spawns its root classes while the worker
    already runs them, in both engines, so the roots are gated
    (:func:`_gated_roots`) until all are queued; without the gate the
    h2d and compaction bytes of a depth-first refresh follow the thread
    timing. Compaction bills the arena's row high-water mark times the
    merged width, and is also held to that definition."""
    for miner in (rfpm._ClassMiner, tfpm._ClassMiner):
        monkeypatch.setattr(miner, "spawn_roots",
                            _gated_roots(miner.spawn_roots))
    db = zipf_db(1500)
    kw = dict(granularity=granularity, n_workers=1, max_k=3, arena=arena)
    sm = port_miner(60, 12, initial_db=db[:1440], **kw)
    ref = rs.StreamingMiner(60, 12, initial_db=db[:1440],
                            backend="pallas-interpret", **kw)
    try:
        assert sm.arena.h2d_bytes == ref.arena.h2d_bytes
        sparse = reused = 0
        for lo, hi in [(1440, 1440), (1440, 1470), (1470, 1500)]:
            if hi > lo:
                ing, ring = sm.ingest(db[lo:hi]), ref.ingest(db[lo:hi])
                assert (ing.segment, ing.words, ing.payload_bytes,
                        ing.h2d_bytes) == (ring.segment, ring.words,
                                           ring.payload_bytes,
                                           ring.h2d_bytes)
            rep, rrep = sm.refresh(), ref.refresh()
            assert dict(sm.snapshot.supports) == dict(ref.snapshot.supports)
            assert dict(sm.snapshot.border) == dict(ref.snapshot.border)
            for g in GAUGES:
                assert getattr(rep, g) == getattr(rrep, g), g
            assert rep.compaction_bytes == rrep.compaction_bytes == (
                rep.compacted_segments and sm.arena.n_rows
                * sm.arena.seg_words(0) * 4)
            assert rep.metrics.sparse_sweeps == rrep.metrics.sparse_sweeps
            sparse += rep.metrics.sparse_sweeps
            reused += rep.reused
        assert sm.arena.n_segments == ref.arena.n_segments == 1
        assert sparse > 0 and reused > 0
    finally:
        sm.close()
        ref.close()


def test_multiple_ingests_between_refreshes_fold_together():
    full = rand_db(300, seed=3)
    ms = 30
    sm = port_miner(16, ms, initial_db=full[:200], max_k=4)
    try:
        sm.refresh()
        sm.ingest(full[200:240])
        sm.ingest(full[240:270])
        sm.ingest(full[270:])
        assert sm.needs_refresh
        rep = sm.refresh()
        assert rep.segments_refreshed == (1, 2, 3)
        assert not sm.needs_refresh
        assert dict(sm.snapshot.supports) == batch_mine(full, 16, ms,
                                                        max_k=4)
    finally:
        sm.close()


def test_empty_initial_db_then_ingest():
    """Generation 0 serves the empty snapshot, and the first refresh
    after ingest equals batch mining the batches alone."""
    sm = port_miner(16, 20, max_k=4)
    try:
        assert sm.snapshot.generation == 0
        assert dict(sm.snapshot.supports) == {}
        assert sm.refresh().frequent == 0           # refresh of nothing
        db = rand_db(200, seed=5)
        sm.ingest(db[:150])
        sm.ingest(db[150:])
        sm.refresh()
        assert dict(sm.snapshot.supports) == batch_mine(db, 16, 20,
                                                        max_k=4)
    finally:
        sm.close()


def test_ingest_rejects_out_of_range_items():
    sm = port_miner(8, 2)
    with pytest.raises(ValueError, match="item id"):
        sm.ingest([[1, 2], [7, 9]])
    with pytest.raises(ValueError, match="item id"):
        port_miner(8, 2, initial_db=[[8]])


def test_miner_without_device_raises_when_no_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.StreamingMiner(4, 1, initial_db=[[0, 1]])


# ------------------------------------------------- incremental bounds
def retail_stream(n=3000, cut=2980):
    db, p = load("retail", seed=0)
    db = db[:n]
    return db, db[:cut], db[cut:], p.n_items


@pytest.mark.parametrize("granularity", ["bucket", "depth-first"])
def test_incremental_refresh_touches_fewer_rows(granularity):
    """A small ingest invalidates few equivalence classes: the refresh
    reads fewer rows and bytes than a from-scratch mine at the same
    granularity, and most candidates are answered from the reuse
    store."""
    db, init, batch, n_items = retail_stream()
    ms = 30
    sm = port_miner(n_items, ms, initial_db=init, max_k=4, n_workers=3,
                    granularity=granularity)
    try:
        sm.refresh()
        rep = sm.refresh()                          # nothing pending:
        assert rep.rows_touched == 0                # zero rows re-read
        sm.ingest(batch)
        rep = sm.refresh()
        ref, full = tfpm.mine(rpack(db, n_items), ms, device="cpu",
                              max_k=4, n_workers=3,
                              granularity=granularity)
        assert dict(sm.snapshot.supports) == ref
        assert rep.rows_touched < full.rows_touched
        assert rep.bytes_swept < full.bytes_swept
        assert rep.reused > rep.swept_delta + rep.swept_full
    finally:
        sm.close()


def test_ingest_h2d_bills_only_the_new_segment():
    """Eager device backing: an ingest uploads exactly the new segment's
    base payload — never the whole arena again."""
    db, init, batch, n_items = retail_stream(n=1200, cut=1100)
    sm = port_miner(n_items, 20, initial_db=init, max_k=3, arena="jax",
                    n_workers=2)
    try:
        base_h2d = sm.arena.h2d_bytes               # eager initial upload
        assert base_h2d == sm.arena.seg_nbytes(0)
        rep = sm.ingest(batch)
        assert rep.h2d_bytes == rep.payload_bytes == sm.arena.seg_nbytes(1)
        assert rep.payload_bytes < base_h2d
        sm.refresh()
        assert dict(sm.snapshot.supports) == batch_mine(db, n_items, 20,
                                                        max_k=3)
    finally:
        sm.close()


# ------------------------------------------------- border classification
def test_border_classification_stayed_born_died():
    """A fractional min_support rises with the database, so the border
    moves both ways."""
    init = [[0, 1, 2]] * 60 + [[0, 1]] * 3 + [[3, 4]] * 45
    sm = port_miner(6, 0.4, initial_db=init, max_k=4)
    ref = rs.StreamingMiner(6, 0.4, initial_db=init, max_k=4,
                            backend="numpy")
    try:
        r0 = sm.refresh()
        ref.refresh()
        g1 = dict(sm.snapshot.supports)
        assert r0.born == len(g1) > 0 and (3, 4) in g1
        sm.ingest([[0, 1, 2, 5]] * 90)
        ref.ingest([[0, 1, 2, 5]] * 90)
        r1, rr1 = sm.refresh(), ref.refresh()
        g2 = dict(sm.snapshot.supports)
        assert g2 == dict(ref.snapshot.supports)
        assert (r1.stayed, r1.born, r1.died) == (rr1.stayed, rr1.born,
                                                  rr1.died)
        assert r1.died == len(set(g1) - set(g2)) > 0
        assert r1.born == len(set(g2) - set(g1)) > 0
        assert r1.stayed == len(set(g1) & set(g2)) > 0
        assert (3, 4) not in g2 and (0, 1, 5) in g2
    finally:
        sm.close()
        ref.close()


def test_fixed_absolute_threshold_nothing_dies():
    full = rand_db(300, seed=9)
    sm = port_miner(16, 25, initial_db=full[:200], max_k=4)
    try:
        sm.refresh()
        g1 = set(sm.snapshot.supports)
        sm.ingest(full[200:])
        rep = sm.refresh()
        assert rep.died == 0                        # supports only grow
        assert g1 <= set(sm.snapshot.supports)
    finally:
        sm.close()


# A candidate that falls off the frontier and comes back, under a
# fraction threshold of 0.5: (0, 1, 2) is swept at generation 1 (a
# border itemset, support 1); at generation 2 its subset (1, 2) dies, so
# it is no candidate and its known count misses the new segment's
# occurrence; at generation 3 (1, 2) returns and (0, 1, 2) (support 8 of
# 16) is frequent again.
RETURN_INIT = [[0, 1, 2], [0, 1], [0, 2], [1, 2]]
RETURN_BATCHES = ([[0, 1, 2], [0, 1], [0, 2], [0, 1], [0, 2], [0]],
                  [[0, 1, 2]] * 6)


def _returning(miner):
    """Refresh ``miner`` at each of the three generations; returns each
    generation's (min_support, supports, border)."""
    out = []
    try:
        for batch in ((),) + RETURN_BATCHES:
            if batch:
                miner.ingest(batch)
            rep = miner.refresh()
            snap = miner.snapshot
            out.append((rep.min_support, dict(snap.supports),
                        dict(snap.border)))
    finally:
        miner.close()
    return out


@pytest.mark.parametrize("granularity",
                         ["bucket", "candidate", "depth-first", "auto"])
def test_candidate_returning_after_a_death_is_exact(granularity):
    """Every generation equals the batch mine at its threshold, and every
    border support is exact: a known candidate whose subset died is
    swept in full when it returns, not delta-swept from a stale count."""
    gens = _returning(port_miner(3, 0.5, initial_db=RETURN_INIT,
                                 granularity=granularity, n_workers=1,
                                 max_k=3))
    db = list(RETURN_INIT)
    for (ms, supports, border), batch in zip(gens, ((),) + RETURN_BATCHES):
        db += batch
        assert supports == brute_force_frequent(db, ms, max_k=3)
        for x, s in border.items():
            assert s == sum(set(x) <= set(t) for t in db), x
    assert gens[2][1][(0, 1, 2)] == 8


def test_stale_returning_candidate_is_the_known_divergence():
    """The reference's streaming miner keeps the stale count: at
    generation 2 its border serves (0, 1, 2) at 1 (true: 2), and at
    generation 3 it misses (0, 1, 2) (true: 8, the threshold 8). The
    port drops the stale entry (``DeltaPlan.drop_unswept``)."""
    kw = dict(initial_db=RETURN_INIT, n_workers=1, max_k=3)
    ref = _returning(rs.StreamingMiner(3, 0.5, backend="numpy", **kw))
    got = _returning(port_miner(3, 0.5, **kw))
    assert ref[0] == got[0]
    assert ref[1][2][(0, 1, 2)] == 1 and (0, 1, 2) not in got[1][2]
    assert (0, 1, 2) not in ref[2][1] and got[2][1][(0, 1, 2)] == 8
    assert {x: s for x, s in got[2][1].items() if x != (0, 1, 2)} == \
        ref[2][1]


# ------------------------------------------------- snapshot publication
def test_snapshot_swap_is_atomic_queries_see_old_generation():
    full = rand_db(400, seed=13)
    ms = 40
    sm = port_miner(16, ms, initial_db=full[:300], max_k=4)
    try:
        sm.refresh()
        srv = ts.PatternServer(sm)
        g1 = dict(srv.frequent())
        sm.ingest(full[300:])
        seen = {}

        def probe(next_snap):
            # after mining, just BEFORE the swap: still generation 1
            seen["gen"] = srv.snapshot.generation
            seen["supports"] = dict(srv.frequent())
            seen["next"] = next_snap.generation

        sm.refresh(before_publish=probe)
        assert seen["gen"] == 1 and seen["next"] == 2
        assert seen["supports"] == g1
        assert srv.snapshot.generation == 2
        assert dict(srv.frequent()) == batch_mine(full, 16, ms, max_k=4)
    finally:
        sm.close()


def test_queries_during_concurrent_refresh_are_consistent():
    full = rand_db(600, seed=17)
    sm = port_miner(16, 50, initial_db=full[:400], max_k=5, n_workers=3)
    try:
        sm.refresh()
        g1 = dict(sm.snapshot.supports)
        sm.ingest(full[400:])
        srv = ts.PatternServer(sm)
        stop = threading.Event()
        bad = []

        def query_loop():
            while not stop.is_set():
                snap = srv.snapshot
                if snap.generation == 1 and dict(snap.supports) != g1:
                    bad.append("gen1 mutated")
                if snap.generation not in (1, 2):
                    bad.append(f"gen {snap.generation}")

        t = threading.Thread(target=query_loop)
        t.start()
        try:
            sm.refresh()
        finally:
            stop.set()
            t.join(timeout=30)
        assert not t.is_alive() and not bad
        assert srv.snapshot.generation == 2
    finally:
        sm.close()


def test_snapshot_query_api():
    snap = ts.PatternSnapshot(3, 100, 10, {
        (1,): 50, (2,): 40, (1, 2): 30, (1, 3): 20, (1, 2, 4): 12},
        device="cpu")
    assert snap.support((2, 1)) == 30           # order-insensitive
    assert snap.support((9,)) is None
    assert snap.top_k((1,), 2) == [((1, 2), 30), ((1, 3), 20)]
    assert snap.top_k((), 1) == [((1,), 50)]
    assert snap.frequent(25) == {(1,): 50, (2,): 40, (1, 2): 30}
    assert len(snap.frequent()) == 5


def test_pattern_server_counts_queries():
    sm = port_miner(8, 2, initial_db=[[0, 1], [0, 1], [1, 2]])
    try:
        sm.refresh()
        srv = ts.PatternServer(sm)
        srv.support((0, 1))
        srv.top_k((0,))
        srv.frequent()
        assert srv.queries == 3
    finally:
        sm.close()


# ------------------------------------------------- property tests
@settings(max_examples=10, deadline=None)
@given(st.data())
def test_property_interleaved_ingest_refresh_equals_batch(data):
    """Random databases, split points and refresh cadence, both
    incremental granularities: the final refresh equals the brute-force
    frequent set of the concatenation."""
    n_items = data.draw(st.integers(5, 10))
    n_tx = data.draw(st.integers(8, 60))
    seed = data.draw(st.integers(0, 10_000))
    rng = np.random.default_rng(seed)
    db = [sorted(rng.choice(n_items,
                            size=rng.integers(1, min(5, n_items) + 1),
                            replace=False).tolist())
          for _ in range(n_tx)]
    n_cuts = data.draw(st.integers(1, 4))
    cuts = sorted(data.draw(
        st.lists(st.integers(0, n_tx), min_size=n_cuts, max_size=n_cuts)))
    granularity = data.draw(st.sampled_from(["bucket", "depth-first"]))
    ms = data.draw(st.integers(1, max(1, n_tx // 3)))
    sm = port_miner(n_items, ms, initial_db=db[:cuts[0]],
                    granularity=granularity, n_workers=2, max_k=4)
    try:
        prev = cuts[0]
        for cut in cuts[1:]:
            sm.ingest(db[prev:cut])
            prev = cut
            if data.draw(st.booleans()):            # refresh sometimes:
                sm.refresh()                        # pending segs pile up
        sm.ingest(db[prev:])
        sm.refresh()
        assert dict(sm.snapshot.supports) == brute_force_frequent(
            db, ms, max_k=4)
    finally:
        sm.close()


@settings(max_examples=10, deadline=None)
@given(st.data())
def test_property_fraction_threshold_every_generation_equals_batch(data):
    """A fraction threshold rises with the database, so itemsets die and
    return: after every refresh the published generation equals the
    brute-force frequent set of the refreshed prefix at that
    generation's threshold."""
    n_items = data.draw(st.integers(3, 8))
    n_tx = data.draw(st.integers(8, 60))
    seed = data.draw(st.integers(0, 10_000))
    rng = np.random.default_rng(seed)
    db = [sorted(rng.choice(n_items,
                            size=rng.integers(1, min(5, n_items) + 1),
                            replace=False).tolist())
          for _ in range(n_tx)]
    cuts = sorted(data.draw(st.lists(st.integers(1, n_tx), min_size=2,
                                     max_size=5)))
    granularity = data.draw(st.sampled_from(["bucket", "depth-first"]))
    frac = data.draw(st.floats(0.1, 0.6))
    sm = port_miner(n_items, frac, initial_db=db[:cuts[0]],
                    granularity=granularity, n_workers=2, max_k=4)
    bounds = cuts + [n_tx]
    try:
        for i, n in enumerate(bounds):
            if i:
                sm.ingest(db[bounds[i - 1]:n])
            rep = sm.refresh()
            assert dict(sm.snapshot.supports) == brute_force_frequent(
                db[:n], rep.min_support, max_k=4)
    finally:
        sm.close()


@settings(max_examples=12, deadline=None)
@given(st.data())
def test_property_mining_identical_across_compaction_cadence(data):
    """Identical published supports whatever the compaction cadence —
    never, after every refresh, or at random points — at both
    incremental granularities; recycled prefix slots span the merges."""
    n_items = data.draw(st.integers(6, 10))
    n_tx = data.draw(st.integers(30, 80))
    seed = data.draw(st.integers(0, 10_000))
    rng = np.random.default_rng(seed)
    db = [sorted(rng.choice(n_items,
                            size=rng.integers(1, min(5, n_items) + 1),
                            replace=False).tolist())
          for _ in range(n_tx)]
    cadence = data.draw(st.sampled_from(["never", "every", "random"]))
    granularity = data.draw(st.sampled_from(["bucket", "depth-first"]))
    ms = data.draw(st.integers(1, max(1, n_tx // 4)))
    cut = data.draw(st.integers(0, n_tx - 1))
    sm = port_miner(n_items, ms, initial_db=db[:cut],
                    granularity=granularity, n_workers=2, max_k=4,
                    compact_ratio=0.0, compact_segments=10 ** 9)
    try:
        sm.refresh()
        lo = cut
        while lo < n_tx:
            hi = min(n_tx, lo + data.draw(st.integers(5, 20)))
            sm.ingest(db[lo:hi])
            lo = hi
            sm.refresh()
            if cadence == "every" or (cadence == "random"
                                      and data.draw(st.booleans())):
                sm.compact_now()
        assert dict(sm.snapshot.supports) == batch_mine(
            db, n_items, ms, max_k=4)
    finally:
        sm.close()


def test_failed_refresh_leaves_state_intact_and_retry_is_exact(
        monkeypatch):
    """A refresh that dies mid-mine must not corrupt the miner: state is
    committed only at publish, so a retry folds the SAME pending
    segments once."""
    full = rand_db(300, seed=21)
    ms = 30
    sm = port_miner(16, ms, initial_db=full[:250], max_k=4, n_workers=2)
    try:
        sm.refresh()
        g1 = dict(sm.snapshot.supports)
        sm.ingest(full[250:])

        class Bomb(NumpyBackend):
            def sweep_many(self, arena, requests):
                raise RuntimeError("mid-refresh boom")

        sm.close()        # the next refresh rebuilds the runtime
        with monkeypatch.context() as m:
            m.setattr(tfpm, "resolve_backend", lambda spec: Bomb())
            with pytest.raises(RuntimeError, match="boom"):
                sm.refresh()
        sm.close()        # drop the poisoned runtime before the retry
        assert sm.snapshot.generation == 1
        assert dict(sm.snapshot.supports) == g1
        assert sm.needs_refresh
        sm.refresh()
        assert dict(sm.snapshot.supports) == batch_mine(full, 16, ms,
                                                        max_k=4)
    finally:
        sm.close()


# ------------------------------------------------- segment compaction
def test_compaction_policy_fires_and_bounds_segments():
    full = rand_db(300, seed=3)
    sm = port_miner(16, 30, initial_db=full[:200], n_workers=2, max_k=4)
    ref = rs.StreamingMiner(16, 30, initial_db=full[:200], n_workers=2,
                            max_k=4, backend="numpy")
    try:
        sm.refresh()
        ref.refresh()
        compacted = 0
        for lo in range(200, 300, 20):
            sm.ingest(full[lo:lo + 20])
            ref.ingest(full[lo:lo + 20])
            rep, rrep = sm.refresh(), ref.refresh()
            assert (rep.compacted_segments, rep.compaction_bytes) == (
                rrep.compacted_segments, rrep.compaction_bytes)
            compacted += rep.compacted_segments
            if rep.compacted_segments:
                assert rep.compaction_bytes > 0
        assert compacted > 0
        assert sm.arena.n_segments <= 2
        assert dict(sm.snapshot.supports) == batch_mine(full, 16, 30,
                                                        max_k=4)
    finally:
        sm.close()
        ref.close()


def test_compaction_disabled_accumulates_segments():
    full = rand_db(120, seed=5)
    sm = port_miner(16, 12, initial_db=full[:60], n_workers=2, max_k=4,
                    compact_ratio=0.0, compact_segments=10 ** 9)
    try:
        sm.refresh()
        for lo in range(60, 120, 20):
            sm.ingest(full[lo:lo + 20])
            rep = sm.refresh()
            assert rep.compacted_segments == 0
        assert sm.arena.n_segments == 4
        assert sm.arena.compactions == 0
        assert sm.compact_now() == 3
        assert sm.arena.n_segments == 1
        assert dict(sm.snapshot.supports) == batch_mine(full, 16, 12,
                                                        max_k=4)
        # one more generation over the merged arena stays exact
        more = rand_db(30, seed=6)
        sm.ingest(more)
        sm.refresh()
        assert dict(sm.snapshot.supports) == batch_mine(full + more, 16,
                                                        12, max_k=4)
    finally:
        sm.close()


@pytest.mark.parametrize("granularity", ["bucket", "depth-first"])
def test_compact_every_refresh_matches_batch_mine(granularity):
    full = rand_db(200, seed=17)
    sm = port_miner(16, 20, initial_db=full[:120], granularity=granularity,
                    n_workers=2, max_k=4, compact_ratio=0.0,
                    compact_segments=10 ** 9)
    try:
        sm.refresh()
        sm.compact_now()
        for lo in range(120, 200, 40):
            sm.ingest(full[lo:lo + 40])
            sm.refresh()
            assert sm.compact_now() >= 0
            assert sm.arena.n_segments == 1
        assert dict(sm.snapshot.supports) == batch_mine(
            full, 16, 20, granularity=granularity, max_k=4)
    finally:
        sm.close()


# ------------------------------------------- refresh/ingest overlap
def test_ingest_during_inflight_refresh_lands_next_generation():
    full = rand_db(300, seed=9)
    sm = port_miner(16, 30, initial_db=full[:260], n_workers=2, max_k=4)
    try:
        sm.refresh()
        sm.ingest(full[260:280])
        seen = {}

        def hook(snapshot):
            # mid-refresh (pre-publish): a blocking ingest would
            # deadlock right here
            rep = sm.ingest(full[280:])
            seen["ingest_wall"] = rep.wall_s
            seen["needs_refresh"] = sm.needs_refresh

        rep2 = sm.refresh(before_publish=hook)
        assert sm.snapshot.n_transactions == 280
        assert seen["needs_refresh"] is True
        assert dict(sm.snapshot.supports) == batch_mine(full[:280], 16,
                                                        30, max_k=4)
        rep3 = sm.refresh()
        assert rep3.generation == rep2.generation + 1
        assert sm.snapshot.n_transactions == 300
        assert dict(sm.snapshot.supports) == batch_mine(full, 16, 30,
                                                        max_k=4)
    finally:
        sm.close()


def test_metrics_registry_reads_stream_and_runtime_gauges():
    full = rand_db(120, seed=2)
    sm = port_miner(16, 12, initial_db=full[:100], n_workers=2, max_k=3)
    try:
        sm.refresh()
        sm.ingest(full[100:])
        snap = sm.metrics_registry().snapshot()
        assert snap["stream"]["pending_segments"] == 1
        assert snap["stream"]["refresh_lag_s"] > 0
        assert {"compactions", "compaction_bytes"} <= set(snap["arena"])
        sm.refresh()
        assert sm.refresh_lag == 0.0
    finally:
        sm.close()
