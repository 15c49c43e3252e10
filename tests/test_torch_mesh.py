"""The port's multi-device mesh against the reference's on the same seeded
inputs (``device="cpu"``): a one-device mesh against the shared-memory
engine over every granularity and policy, two logical shards over the
four granularities on both backends, ``mine_distributed``, the sharded
arena's ownership, d2d billing, migration and per-shard mirrors issued
call by call to both arenas, cross-shard steals, and the streaming
miner's mesh cases. Supports and byte gauges are integers: exact
equality throughout, except where thread timing decides which shard
reads a row (then only the whole-row structure is held)."""
import threading

import jax
import numpy as np
import pytest
import torch
from _hyp import given, settings, st
from jax.sharding import Mesh

from repro.core import distributed_fpm as rdist
from repro.core import fpm as rfpm
from repro.core import streaming as rs
from repro.core import tidlist as rtl
from repro.core.scheduler import ClusteredPolicy as RClusteredPolicy
from repro.core.scheduler import TaskScheduler as RTaskScheduler
from repro_torch.core import distributed_fpm as tdist
from repro_torch.core import fpm as tfpm
from repro_torch.core import streaming as ts
from repro_torch.core import tidlist as ttl
from repro_torch.core.scheduler import ClusteredPolicy, TaskScheduler
from repro_torch.core.tidlist import BitmapArena, from_device_words
from repro_torch.data.transactions import load

GRANULARITIES = ["bucket", "candidate", "depth-first"]
POLICIES = ["cilk", "fifo", "clustered", "nn"]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def dataset():
    db, p = load("mushroom", seed=0)
    db = db[:250]
    bm = ttl.pack_database(db, p.n_dense_items)
    ms = int(0.22 * len(db))
    return bm, ms, tfpm.mine_serial(bm, ms, max_k=4)


@pytest.fixture(scope="module")
def one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


# ------------------------------------------------- support equivalence
@pytest.mark.parametrize("granularity", GRANULARITIES)
@pytest.mark.parametrize("policy", POLICIES)
def test_one_device_mesh_matches_shared_memory(dataset, one_device_mesh,
                                               policy, granularity):
    """A one-device mesh runs the sharded path with one shard and must
    equal the shared-memory engine and the reference's one-device mesh."""
    bm, ms, ref = dataset
    kw = dict(policy=policy, n_workers=3, max_k=4, granularity=granularity)
    got, met = tfpm.mine(bm, ms, device="cpu", mesh=[CPU], **kw)
    want, wmet = rfpm.mine(bm, ms, backend="numpy", mesh=one_device_mesh,
                           **kw)
    assert got == want == ref, (policy, granularity)
    assert met.n_devices == wmet.n_devices == 1
    assert met.d2d_bytes == wmet.d2d_bytes == 0   # nothing is foreign
    assert len(met.per_device) == 1
    if granularity == "depth-first":
        assert met.cache_misses == 0   # the handoff survives the mesh


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("granularity", GRANULARITIES + ["auto"])
def test_logical_two_shard_mesh_matches(dataset, granularity, backend):
    """mesh=2 (logical shards): ownership, per-shard dispatchers and d2d
    accounting, with the reference's supports."""
    bm, ms, ref = dataset
    kw = dict(policy="clustered", n_workers=4, max_k=4,
              granularity=granularity, mesh=2)
    got, met = tfpm.mine(bm, ms, device="cpu", backend=backend, **kw)
    want, wmet = rfpm.mine(bm, ms, backend="numpy", **kw)
    assert got == want == ref, granularity
    assert met.n_devices == wmet.n_devices == 2
    assert len(met.per_device) == 2
    assert [d["device"] for d in met.per_device] == [0, 1]
    assert sum(d["sweep_requests"] for d in met.per_device) == \
        met.scheduler["sweeps_submitted"]
    # traffic is whole rows or whole sparse payloads; bucket and
    # candidate grain read only their own shard's rows
    if granularity in ("bucket", "candidate"):
        assert met.d2d_bytes == wmet.d2d_bytes == 0
        assert met.migrations == wmet.migrations == 0


@pytest.mark.parametrize("mesh", [0, -1, [], "cuda"])
def test_mesh_raises_on_bad_shard_count(dataset, mesh):
    bm, ms, _ = dataset
    with pytest.raises(ValueError, match="mesh"):
        tfpm.mine(bm, ms, device="cpu", mesh=mesh)
    if isinstance(mesh, int):
        with pytest.raises(ValueError, match="mesh"):
            rfpm.mine(bm, ms, mesh=mesh)


def test_mesh_fewer_workers_than_shards_grows(dataset):
    """n_workers is raised to cover every shard (a shard without a worker
    would starve its dispatcher)."""
    bm, ms, ref = dataset
    got, met = tfpm.mine(bm, ms, device="cpu", n_workers=1, max_k=3,
                         mesh=3)
    want, wmet = rfpm.mine(bm, ms, n_workers=1, max_k=3, mesh=3,
                           backend="numpy")
    assert got == want == {k: v for k, v in ref.items() if len(k) <= 3}
    assert met.n_devices == wmet.n_devices == 3
    assert len(met.per_device) == 3


def test_mesh_over_devices_without_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert tfpm.mesh_over_devices(1) is None
    assert tfpm.mesh_over_devices(2) == 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tfpm.mesh_over_devices(2) == [torch.device("cuda:0"),
                                         torch.device("cuda:1")]
    assert tfpm.mesh_over_devices(3) == 3


# ------------------------------------------------------- compat shim
@pytest.mark.parametrize("policy", ["clustered", "round_robin"])
def test_mine_distributed_matches_reference(dataset, one_device_mesh,
                                            policy):
    bm, ms, ref = dataset
    got, stats = tdist.mine_distributed(bm, ms, 2, policy=policy, max_k=4,
                                        device="cpu")
    want, wstats = rdist.mine_distributed(bm, ms, 2, policy=policy,
                                          max_k=4, backend="numpy")
    assert got == want == ref, policy
    assert set(stats) == set(wstats)
    for key in ("levels", "candidates", "n_devices"):
        assert stats[key] == wstats[key], key
    assert stats["n_devices"] == 2
    # the paper's locality claim through the shim: clustered buckets
    # read fewer rows than scattered full-join candidates
    one, _ = tdist.mine_distributed(bm, ms, [CPU], policy=policy, max_k=4,
                                    device="cpu")
    assert one == ref
    if policy == "clustered":
        rr = tdist.mine_distributed(bm, ms, 2, policy="round_robin",
                                    max_k=4, device="cpu")[1]
        assert stats["rows_touched"] < rr["rows_touched"]


def test_mine_distributed_rejects_unknown_policy(dataset):
    bm, ms, _ = dataset
    for mod in (tdist, rdist):
        with pytest.raises(ValueError):
            mod.mine_distributed(bm, ms, 2, policy="nope")


# ------------------------------------------- steal-as-migration path
def _forced_steal(arena_cls, sched_cls, pol_cls, kw):
    """The reference's deterministic cross-device bucket steal on one
    package: one worker blocks inside a bucket, a second bucket carrying
    an arena handle lands on that worker's queue, and the other shard's
    only worker must steal it. Returns what the packages must agree on."""
    rows = np.random.default_rng(3).integers(0, 2 ** 32, size=(4, 8),
                                             dtype=np.uint32)
    arena = arena_cls.from_bitmaps(rows, backing="numpy", n_shards=2, **kw)
    sched = sched_cls(2, pol_cls(2, cluster_of=lambda a: a),
                      device_of=[0, 1],
                      migrate_cb=lambda hs, src, dst: arena.migrate(hs, dst))
    ran_on, where = [], {}
    started, migrated = threading.Event(), threading.Event()
    migrate = arena.migrate

    def spy_migrate(hs, dst):
        n = migrate(hs, dst)
        migrated.set()
        return n

    arena.migrate = spy_migrate

    def blocker():
        where["victim"] = sched.worker_device()
        started.set()
        migrated.wait(timeout=10)

    sched.spawn(blocker, attr=0, worker=0)
    assert started.wait(timeout=5)
    victim = where["victim"]
    h = arena.materialize(0, 1, shard=victim)
    sched.spawn(lambda: ran_on.append(sched.worker_device()), attr=1,
                worker=victim, handles=(h,))
    sched.wait_all()
    sched.shutdown()
    assert migrated.is_set(), "cross-device steal never migrated"
    return (ran_on == [1 - victim], arena.owner_of(h) == 1 - victim,
            arena.d2d_bytes, arena.migrations,
            sched.merged_stats()["steal_migrations"] >= 1)


def test_forced_cross_device_steal_migrates_handles():
    got = _forced_steal(BitmapArena, TaskScheduler, ClusteredPolicy,
                        {"device": "cpu"})
    want = _forced_steal(rtl.BitmapArena, RTaskScheduler, RClusteredPolicy,
                         {})
    assert got == want == (True, True, 8 * 4, 1, True)


def test_same_device_steal_does_not_migrate():
    """Steals inside one shard are the cheap path: no migration, no d2d."""
    rows = np.random.default_rng(4).integers(0, 2 ** 32, size=(3, 4),
                                             dtype=np.uint32)
    arena = BitmapArena.from_bitmaps(rows, device="cpu", backing="numpy")
    h = arena.materialize(0, 1, shard=0)
    calls = []
    sched = TaskScheduler(2, ClusteredPolicy(2, cluster_of=lambda a: a),
                          device_of=[0, 0],
                          migrate_cb=lambda hs, src, dst: calls.append(hs))
    done = threading.Event()
    sched.spawn(lambda: done.wait(timeout=2), attr=0, worker=0)
    sched.spawn(done.set, attr=1, worker=0, handles=(h,))
    sched.wait_all()
    sched.shutdown()
    assert calls == []
    assert arena.d2d_bytes == 0 and arena.migrations == 0


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_depth_first_logical_mesh_records_d2d_on_steals(backend):
    """Depth-first over two logical shards: supports exact, the handoff
    intact, and every cross-shard byte a whole row (steal timing decides
    how many; the deterministic case is the forced steal above)."""
    db, p = load("mushroom", seed=1)
    db = db[:400]
    bm = ttl.pack_database(db, p.n_dense_items)
    ms = int(0.2 * len(db))
    got, met = tfpm.mine(bm, ms, device="cpu", backend=backend,
                         policy="clustered", n_workers=2, max_k=4,
                         granularity="depth-first", mesh=2,
                         representation="bitmap")
    want = rfpm.mine(bm, ms, backend="numpy", policy="clustered",
                     n_workers=2, max_k=4, granularity="depth-first",
                     mesh=2, representation="bitmap")[0]
    assert got == want == tfpm.mine_serial(bm, ms, max_k=4)
    assert met.cache_misses == 0
    assert met.d2d_bytes % (bm.shape[1] * 4) == 0
    assert met.migrations <= met.scheduler["steal_migrations"] * 64


def test_shard_dispatchers_own_their_backend_buffers(dataset):
    """Each shard's dispatcher sweeps through a TorchBackend of its own:
    no two share the staging or read-back buffer they reuse."""
    bm, ms, ref = dataset
    store = BitmapArena.from_bitmaps(bm, device="cpu", n_shards=3)
    run = tfpm.MiningRun(store, policy="clustered", n_workers=6,
                         granularity="bucket", cache_size=8,
                         backend="torch", representation="bitmap")
    result, frequent = tfpm._level1(bm, ms)
    try:
        tfpm.mine_more(run, ms, 3, result, frequent)
    finally:
        run.close()
    assert result == {k: v for k, v in ref.items() if len(k) <= 3}
    backends = [d.backend for d in run.dispatchers]
    assert len({id(b) for b in backends}) == 3
    assert [d.shard for d in run.dispatchers] == [0, 1, 2]
    assert all(d.flushes > 0 for d in run.dispatchers)
    ptrs = [b._stage.data_ptr() for b in backends] + [
        b._counts.data_ptr() for b in backends]
    assert len(set(ptrs)) == 6


# ----------------------------------------------------- sharded arena
RNG_SEED = 11


def sharded_pair(n=6, w=4, backing="numpy", n_shards=2):
    rows = np.random.default_rng(RNG_SEED).integers(
        0, 2 ** 32, size=(n, w), dtype=np.uint32)
    port = BitmapArena.from_bitmaps(rows, device="cpu", backing=backing,
                                    n_shards=n_shards)
    ref = rtl.BitmapArena.from_bitmaps(rows, backing=backing,
                                       n_shards=n_shards)
    return port, ref, rows


def gauges(a):
    return a.d2d_bytes, a.h2d_bytes, a.migrations


def mirror_rows(port, ref, shard, needed=None, segment=0):
    """Both arenas' ``device_rows(shard, needed=, segment=)`` as uint32
    rows at the segment's width."""
    m = port.device_rows(shard, needed=needed, segment=segment)
    r = ref.device_rows(shard, needed=needed, segment=segment)
    return (from_device_words(m[:, :port.seg_words(segment)].contiguous()),
            np.asarray(r))


def test_sharded_ownership_and_base_replication():
    port, ref, _ = sharded_pair()
    assert port.n_shards == ref.n_shards == 2
    for i in range(port.n_base):
        assert port.owner_of(i) == ref.owner_of(i) == -1
    for a in (port, ref):
        h0 = a.materialize(0, 1, shard=0)
        h1 = a.materialize(2, 3, shard=1)
        assert (a.owner_of(h0), a.owner_of(h1)) == (0, 1)
    with pytest.raises(ValueError, match="2 shards"):
        port.push(np.zeros(4, np.uint32), shard=2)


def test_foreign_fetch_counts_d2d_once_per_residency():
    port, ref, _ = sharded_pair(w=8)
    row_bytes = 8 * 4
    seen = []
    for a in (port, ref):
        h = a.materialize(0, 1, shard=0)
        a.note_access(0, [h, 0, 1])          # owner reads: free
        steps = [a.d2d_bytes]
        a.note_access(1, [h, 0])             # shard 1 fetches h
        steps.append(a.d2d_bytes)
        a.note_access(1, [h])                # resident: no recount
        steps.append(a.d2d_bytes)
        a.release(h)                         # recycling invalidates
        assert a.materialize(2, 3, shard=0) == h
        a.note_access(1, [h])
        steps.append(a.d2d_bytes)
        seen.append(steps)
    assert seen[0] == seen[1] == [0, row_bytes, row_bytes, 2 * row_bytes]


def test_migrate_reowners_and_accounts():
    port, ref, _ = sharded_pair(w=4)
    for a in (port, ref):
        h = a.materialize(0, 1, shard=0)
        assert a.migrate([h, 0, h], dst=1) == 1   # base rows never move
        assert a.owner_of(h) == 1
        a.note_access(1, [h])                     # the owner reads free
    assert gauges(port) == gauges(ref) == (16, 0, 1)


def test_migrate_after_fetch_is_free():
    port, ref, _ = sharded_pair(w=8)
    for a in (port, ref):
        h = a.materialize(0, 1, shard=0)
        a.note_access(1, [h])                # fetch: billed once
        assert a.migrate([h], dst=1) == 1
    assert gauges(port) == gauges(ref) == (32, 0, 1)


def test_sparse_rows_bill_d2d_at_their_size():
    port, ref, _ = sharded_pair(w=8)
    tids = np.array([1, 40, 77, 200], np.uint32)
    for a in (port, ref):
        h = a.push_tids(tids, shard=0)
        a.note_access(1, [h])                # foreign sparse payload
        a.note_access(1, [h])                # resident
        h2 = a.push_tids(tids[:2], shard=1)
        a.migrate([h2], dst=0)
    assert gauges(port) == gauges(ref) == (16 + 8, 0, 1)


def test_migrated_row_lands_on_dst_mirror_without_h2d():
    port, ref, rows = sharded_pair(n=4, w=8, backing="auto")
    for a in (port, ref):
        h = a.materialize(0, 1, shard=0)
        a.device_rows(0, needed=[h])
        a.migrate([h], dst=1)
    m1, r1 = mirror_rows(port, ref, 1, needed=[h])
    np.testing.assert_array_equal(m1[h], rows[0] & rows[1])
    np.testing.assert_array_equal(m1, r1)
    # shard 1's first sync uploads only the replicated base rows; the
    # migrated row rides its prepaid d2d transfer
    assert gauges(port) == gauges(ref) == (32, 2 * 4 * 32 + 32, 1)


def test_sharded_device_mirrors_fetch_foreign_rows():
    """Each mirror holds the base rows and its own rows; a foreign row
    reads as zeros until it is fetched, then equals the host row."""
    port, ref, rows = sharded_pair(n=4, w=8, backing="auto")
    h = port.materialize(0, 1, shard=0)
    assert ref.materialize(0, 1, shard=0) == h
    m0, r0 = mirror_rows(port, ref, 0, needed=[h, 0])
    np.testing.assert_array_equal(m0, r0)
    np.testing.assert_array_equal(m0[h], rows[0] & rows[1])
    m1, r1 = mirror_rows(port, ref, 1, needed=[0, 2])
    np.testing.assert_array_equal(m1, r1)
    np.testing.assert_array_equal(m1[:4], rows)
    assert not m1[h].any()                    # unfetched foreign row
    assert port.d2d_bytes == ref.d2d_bytes == 0
    m1, r1 = mirror_rows(port, ref, 1, needed=[h])
    np.testing.assert_array_equal(m1, r1)
    np.testing.assert_array_equal(m1[h], rows[0] & rows[1])
    assert gauges(port) == gauges(ref)
    assert port.d2d_bytes == 8 * 4


def test_sharded_ctor_validation():
    with pytest.raises(ValueError, match="n_shards"):
        BitmapArena(4, device="cpu", n_shards=0)
    with pytest.raises(ValueError, match="devices"):
        BitmapArena(4, device="cpu", n_shards=2, devices=["cpu"])
    with pytest.raises(ValueError, match="n_shards"):
        rtl.BitmapArena(4, n_shards=0)
    arena = BitmapArena(4, device="cpu", n_shards=2, devices=["cpu", "cpu"])
    assert arena.shard_device(1) == CPU


@pytest.mark.parametrize("backing", ["numpy", "auto", "jax"])
def test_sharded_call_sequences_bill_like_reference(backing):
    """A seeded random sequence of pushes, materializes, sparse pushes,
    releases, migrations, accesses, ingests and compactions on three
    shards, issued call by call to both arenas: d2d, h2d, migrations and
    owners agree at every step, and every mirror equals the reference's
    on every live word-column row (foreign rows zero until fetched)."""
    rng = np.random.default_rng(21)
    port, ref, _ = sharded_pair(n=8, w=5, backing=backing, n_shards=3)
    live = []
    for step in range(90):
        op = int(rng.integers(0, 8))
        shard = int(rng.integers(0, 3))
        if op == 0 or len(live) < 2:
            row = rng.integers(0, 2 ** 32, size=port.n_words,
                               dtype=np.uint32)
            live.append((port.push(row, shard=shard),
                         ref.push(row, shard=shard)))
        elif op == 1:
            p = live[int(rng.integers(len(live)))][0]
            e = int(rng.integers(0, 8))
            if port.rep_of(p) == ttl.REP_BITMAP:
                live.append((port.materialize(p, e, shard=shard),
                             ref.materialize(p, e, shard=shard)))
        elif op == 2:
            tids = np.sort(rng.choice(32 * port.n_words, size=3,
                                      replace=False)).astype(np.uint32)
            live.append((port.push_tids(tids, shard=shard),
                         ref.push_tids(tids, shard=shard)))
        elif op == 3:
            hp, hr = live.pop(int(rng.integers(len(live))))
            port.release(hp)
            ref.release(hr)
        elif op == 4:
            hs = [live[int(i)][0] for i in rng.integers(0, len(live), 3)]
            assert port.migrate(hs, shard) == ref.migrate(hs, shard)
        elif op == 5 and step % 3 == 0:
            seg = rng.integers(0, 2 ** 32, size=(8, int(rng.integers(1, 3))),
                               dtype=np.uint32)
            assert port.add_segment(seg) == ref.add_segment(seg)
        elif op == 6 and port.n_segments > 1:
            up = int(rng.integers(2, port.n_segments + 1))
            assert port.compact(up) == ref.compact(up)
        else:
            needed = [live[int(i)][0] for i in
                      rng.integers(0, len(live), 4)] + [0, 3]
            for g in range(port.n_segments):
                if not port.device_enabled:
                    port.device_rows(shard, needed=needed, segment=g)
                    ref.device_rows(shard, needed=needed, segment=g)
                    continue
                m, r = mirror_rows(port, ref, shard, needed, g)
                for hp, _ in live:
                    if (port.rep_of(hp) == ttl.REP_BITMAP
                            and port.owner_of(hp) in (-1, shard)
                            or hp in needed):
                        np.testing.assert_array_equal(m[hp], r[hp])
                np.testing.assert_array_equal(m[:8], r[:8])
        assert gauges(port) == gauges(ref), step
        for hp, hr in live:
            assert port.owner_of(hp) == ref.owner_of(hr)
    assert port.d2d_bytes > 0 and port.migrations > 0


# ----------------------------------------------------------- streaming
def rand_db(n, items=16, seed=7):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(items, size=rng.integers(2, 7),
                              replace=False).tolist())
            for _ in range(n)]


def batch_mine(db, n_items, ms, **kw):
    return rfpm.mine(rtl.pack_database(db, n_items), ms, backend="numpy",
                     **kw)[0]


@pytest.mark.parametrize("granularity", ["bucket", "depth-first"])
def test_refresh_matches_on_logical_two_shard_mesh(granularity):
    """The streaming equivalence holds over a logical two-shard mesh, and
    agrees with the reference's two-shard streaming miner."""
    full = rand_db(400, seed=11)
    ms = 40
    out = []
    for mod, kw in ((ts, {"device": "cpu"}), (rs, {"backend": "numpy"})):
        sm = mod.StreamingMiner(16, ms, initial_db=full[:300],
                                granularity=granularity, n_workers=4,
                                max_k=5, mesh=2, **kw)
        try:
            sm.refresh()
            sm.ingest(full[300:])
            rep = sm.refresh()
            out.append((dict(sm.snapshot.supports), rep.reused,
                        rep.swept_delta, rep.swept_full))
            assert len(rep.metrics.per_device) == 2
        finally:
            sm.close()
    assert out[0] == out[1]
    assert out[0][0] == batch_mine(full, 16, ms, granularity=granularity,
                                   n_workers=4, max_k=5, mesh=2)


def test_mesh_ingest_bills_like_reference():
    """With eager ("jax") backing every shard mirrors the new segment's
    replicated base rows: an ingest bills the segment's payload once per
    shard, in both packages, and the refreshes bill alike."""
    full = rand_db(300, seed=23)
    reports = []
    for mod, kw in ((ts, {"device": "cpu"}), (rs, {"backend": "numpy"})):
        sm = mod.StreamingMiner(16, 30, initial_db=full[:200], mesh=2,
                                n_workers=2, max_k=3, arena="jax", **kw)
        try:
            rows = [sm.arena.h2d_bytes, sm.refresh().h2d_bytes]
            for lo in (200, 250):
                ing = sm.ingest(full[lo:lo + 50])
                rows.append((ing.h2d_bytes, ing.payload_bytes))
                rows.append(sm.refresh().h2d_bytes)
            reports.append(rows)
        finally:
            sm.close()
    assert reports[0] == reports[1]
    assert reports[0][2] == (2 * reports[0][2][1], reports[0][2][1])


@pytest.mark.parametrize("granularity", ["bucket", "depth-first"])
def test_compact_every_refresh_matches_batch_mine(granularity):
    """Compacting after every refresh on a logical two-shard mesh (each
    shard's mirrors merged) never changes the published supports."""
    full = rand_db(200, seed=17)
    sm = ts.StreamingMiner(16, 20, initial_db=full[:120], device="cpu",
                           granularity=granularity, mesh=2, n_workers=2,
                           max_k=4, compact_ratio=0.0,
                           compact_segments=10 ** 9, arena="jax")
    try:
        sm.refresh()
        sm.compact_now()
        for lo in range(120, 200, 40):
            sm.ingest(full[lo:lo + 40])
            sm.refresh()
            assert sm.compact_now() >= 0
            assert sm.arena.n_segments == 1
        assert dict(sm.snapshot.supports) == batch_mine(full, 16, 20,
                                                        max_k=4)
    finally:
        sm.close()


def test_mesh_queries_round_robin_over_shard_dispatchers():
    """Unknown-itemset queries go to the shards' dispatchers in turn,
    and their answers equal host counts."""
    full = rand_db(300, seed=5)
    sm = ts.StreamingMiner(16, 30, initial_db=full, device="cpu",
                           n_workers=2, max_k=3, mesh=2)
    try:
        sm.refresh()
        server = ts.PatternServer(sm)
        probes = [(0, 1, 2, 3), (4, 5, 6, 7), (1, 3, 5, 7), (2, 4, 6, 8)]
        for x in probes:
            got = server.support_many([x])[0]
            assert got == sum(1 for t in full if set(x) <= set(t))
        reqs = [d.query_requests for d in sm._runtime.dispatchers]
        assert reqs == [2, 2]
    finally:
        sm.close()


@settings(max_examples=6, deadline=None)
@given(st.data())
def test_property_mesh_mining_identical_across_compaction_cadence(data):
    """Published supports equal the reference's batch mine whatever the
    compaction cadence, on a logical two-shard mesh."""
    n_items = data.draw(st.integers(6, 10))
    n_tx = data.draw(st.integers(30, 80))
    rng = np.random.default_rng(data.draw(st.integers(0, 10_000)))
    db = [sorted(rng.choice(n_items,
                            size=rng.integers(1, min(5, n_items) + 1),
                            replace=False).tolist())
          for _ in range(n_tx)]
    cadence = data.draw(st.sampled_from(["never", "every", "random"]))
    granularity = data.draw(st.sampled_from(["bucket", "depth-first"]))
    ms = data.draw(st.integers(1, max(1, n_tx // 4)))
    cut = data.draw(st.integers(0, n_tx - 1))
    sm = ts.StreamingMiner(n_items, ms, initial_db=db[:cut], device="cpu",
                           granularity=granularity, n_workers=2, max_k=4,
                           mesh=2, compact_ratio=0.0,
                           compact_segments=10 ** 9)
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
        assert dict(sm.snapshot.supports) == batch_mine(db, n_items, ms,
                                                        max_k=4)
    finally:
        sm.close()
