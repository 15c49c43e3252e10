"""The port's multi-tenant hub against the reference's on the same seeded
streams (``device="cpu"``): per-tenant snapshots, ``tenant_stats``
counters and query answers, a query burst served while another tenant
refreshes, two tenants refreshing at once from two threads, and the
hub's zero-width first segment. Exact equality throughout: supports are
integers."""
import threading

import numpy as np
import pytest

import repro.core.streaming as rstreaming
import repro_torch.core.streaming as tstreaming
from repro.core.fpm import mine as rmine
from repro.core.tidlist import pack_database as rpack

# tenant_stats keys whose values follow from the ingested data and the
# queries alone, whatever the schedule
STAT_KEYS = ("generation", "transactions", "segments", "frequent", "weight",
             "query_sweeps", "query_sweep_bytes", "queries")


def rand_db(n, items=12, seed=7):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(items, size=rng.integers(2, 6),
                              replace=False).tolist())
            for _ in range(n)]


def brute(db, itemset):
    want = set(itemset)
    return sum(1 for t in db if want <= set(t))


def batch_mine(db, n_items, ms, max_k):
    return rmine(rpack(db, n_items), ms, max_k=max_k, backend="numpy")[0]


def hub(mod, n_items, **kw):
    if mod is tstreaming:
        return mod.TenantHub(n_items, device="cpu", **kw)
    return mod.TenantHub(n_items, backend="numpy", **kw)


def _isolation_run(mod):
    """The reference's isolation/fairness/serving scenario on ``mod``'s
    hub; returns what the two packages must agree on."""
    db_a = rand_db(150, items=12, seed=1)
    db_b = rand_db(120, items=12, seed=2)
    out = {}
    with hub(mod, 12, n_workers=2, max_k=4) as h:
        ta = h.tenant("a", 15, weight=4.0)
        tb = h.tenant("b", 12)
        assert h.tenant("a") is ta          # fetch by id
        out["ingest"] = [(r.segment, r.words, r.payload_bytes)
                         for r in (ta.ingest(db_a[:100]), tb.ingest(db_b))]
        ta.refresh()
        tb.refresh()
        out["gen1"] = (dict(ta.snapshot.supports),
                       dict(tb.snapshot.supports))
        # one tenant's second generation leaves the other untouched
        ta.ingest(db_a[100:])
        ta.refresh()
        out["gen2"] = (dict(ta.snapshot.supports),
                       dict(tb.snapshot.supports), tb.snapshot.generation)
        segs_a = h.arena.tenant_segments("a")
        segs_b = h.arena.tenant_segments("b")
        out["segments"] = (segs_a, segs_b, h.arena.compact(h.arena.n_segments))
        # the len-5 probe exceeds max_k, so it always sweeps
        probes = [(0, 1, 2, 3, 4), (3, 4)]
        out["answers"] = (ta.server.support_many(probes),
                          tb.server.support_many(probes))
        stats = h.tenant_stats()
        out["stats"] = {tid: {k: row[k] for k in STAT_KEYS}
                        for tid, row in stats.items()}
        out["served"] = {tid: row["tasks_served"]
                         for tid, row in stats.items()}
    return out, db_a, db_b


def test_tenant_hub_isolation_fairness_and_serving():
    got, db_a, db_b = _isolation_run(tstreaming)
    want, _, _ = _isolation_run(rstreaming)
    for key in ("ingest", "gen1", "gen2", "segments", "answers", "stats"):
        assert got[key] == want[key], key
    assert got["gen1"] == (batch_mine(db_a[:100], 12, 15, 4),
                           batch_mine(db_b, 12, 12, 4))
    assert got["gen2"] == (batch_mine(db_a, 12, 15, 4),
                           batch_mine(db_b, 12, 12, 4), 1)
    segs_a, segs_b, compacted = got["segments"]
    assert segs_a and segs_b and not set(segs_a) & set(segs_b)
    assert compacted == 0                  # cross-tenant fold refused
    probes = [(0, 1, 2, 3, 4), (3, 4)]
    assert got["answers"] == ([brute(db_a, x) for x in probes],
                              [brute(db_b, x) for x in probes])
    stats = got["stats"]
    assert stats["a"]["queries"]["sweep"] >= 1
    assert stats["b"]["queries"]["sweep"] >= 1
    assert (stats["a"]["generation"], stats["b"]["generation"]) == (2, 1)
    assert stats["a"]["weight"] == 4.0
    # tenant-tagged tasks were served under the fairness rule
    assert got["served"]["a"] > 0 and got["served"]["b"] > 0


def _concurrent_query_run(mod):
    db_a = rand_db(200, items=10, seed=21)
    db_b = rand_db(150, items=10, seed=22)
    probes = [(0, 1, 2, 3, 4), (2, 5)]
    seen = {}
    with hub(mod, 10, n_workers=2, max_k=3) as h:
        ta = h.tenant("a", 20)
        tb = h.tenant("b", 15)
        ta.ingest(db_a)
        ta.refresh()
        tb.ingest(db_b[:100])
        tb.refresh()
        tb.ingest(db_b[100:])

        def hook(snapshot):
            # mid-refresh of B, tenant A's serving stays exact and B
            # still answers over its OLD boundary
            seen["a"] = ta.support_many(probes)
            seen["b"] = tb.support_many(probes)

        tb.refresh(before_publish=hook)
        seen["after"] = tb.support_many(probes)
        seen["snapshots"] = (dict(ta.snapshot.supports),
                             dict(tb.snapshot.supports))
        seen["stats"] = {tid: {k: row[k] for k in STAT_KEYS}
                         for tid, row in h.tenant_stats().items()}
    return seen, db_a, db_b, probes


def test_tenant_queries_concurrent_with_refresh_are_exact():
    got, db_a, db_b, probes = _concurrent_query_run(tstreaming)
    want, _, _, _ = _concurrent_query_run(rstreaming)
    assert got == want
    assert got["a"] == [brute(db_a, x) for x in probes]
    assert got["b"] == [brute(db_b[:100], x) for x in probes]
    assert got["after"] == [brute(db_b, x) for x in probes]
    assert got["snapshots"] == (batch_mine(db_a, 10, 20, 3),
                                batch_mine(db_b, 10, 15, 3))


def test_two_tenants_refresh_concurrently_from_two_threads():
    """Two weighted tenants ingest and refresh at the same time from
    their own threads on one runtime, while a third thread sends query
    bursts to both: every answer is exact over the querying tenant's
    data, and each final snapshot equals the batch mine of its own
    stream."""
    streams = {"a": rand_db(300, items=12, seed=31),
               "b": rand_db(300, items=12, seed=32)}
    weights = {"a": 4.0, "b": 1.0}
    probes = [(0, 1, 2, 3, 4), (1, 5), (2, 3, 7, 8, 9)]
    with hub(tstreaming, 12, n_workers=3, max_k=4) as h:
        ts = {tid: h.tenant(tid, 20, weight=w) for tid, w in weights.items()}
        for tid, t in ts.items():
            t.ingest(streams[tid][:200])
        h.refresh_all()
        errors, answers = [], []
        done = threading.Event()

        def grow(tid):
            try:
                for lo in (200, 250):
                    ts[tid].ingest(streams[tid][lo:lo + 50])
                    ts[tid].refresh()
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        def ask():
            # a burst per millisecond: a bare spin over answers that are
            # dict hits after the first holds the interpreter lock and
            # starves the refreshing threads for minutes
            while not done.wait(0.001):
                for tid, t in ts.items():
                    with h._state:
                        n = t.snapshot.n_transactions
                    answers.append((tid, n, t.support_many(probes)))

        q = threading.Thread(target=ask)
        q.start()
        growers = [threading.Thread(target=grow, args=(tid,)) for tid in ts]
        for g in growers:
            g.start()
        for g in growers:
            g.join(timeout=60)
        done.set()
        q.join(timeout=60)
        assert not any(t.is_alive() for t in (q, *growers))
        assert not errors
        for tid, t in ts.items():
            assert dict(t.snapshot.supports) == batch_mine(
                streams[tid], 12, 20, 4)
        stats = h.tenant_stats()
        assert all(stats[tid]["generation"] == 3 for tid in ts)
        assert all(stats[tid]["tasks_served"] > 0 for tid in ts)
    assert answers
    for tid, n, got in answers:
        # a query answers over the generation published when it was
        # planned: the snapshot read just before, or a later one
        want = {m: [brute(streams[tid][:m], x) for x in probes]
                for m in (200, 250, 300) if m >= n}
        assert got in want.values(), (tid, n, got)


@pytest.mark.parametrize("backing", ["auto", "jax"])
def test_zero_width_first_segment(backing):
    """The hub's arena starts from ``pack_database([], n_items)``, one
    segment of zero words: a mirror of it (eager under ``"jax"``) is
    legal, billed nothing, and never swept; a tenant that never ingested
    refreshes to an empty generation; tenants' sweeps skip it."""
    db = rand_db(90, items=8, seed=5)
    with hub(tstreaming, 8, n_workers=2, max_k=3, arena=backing) as h:
        arena = h.arena
        assert (arena.n_segments, arena.seg_words(0), arena.n_words) == (
            1, 0, 0)
        assert arena.h2d_bytes == 0
        assert arena.device_rows(0).shape == (arena.n_rows, 1)
        ta = h.tenant("a", 9)
        tb = h.tenant("b", 9)               # never ingests
        rep = ta.ingest(db)
        assert rep.segment == 1
        assert rep.h2d_bytes == (rep.payload_bytes if backing == "jax"
                                 else 0)
        reports = h.refresh_all()
        assert set(reports) == {"a", "b"}
        assert dict(ta.snapshot.supports) == batch_mine(db, 8, 9, 3)
        assert dict(tb.snapshot.supports) == {}
        assert tb.snapshot.generation == 1 and tb.snapshot.n_transactions == 0
        assert ta.support_many([(0, 1, 2, 3)]) == [brute(db, (0, 1, 2, 3))]
        assert tb.support_many([(0, 1, 2, 3)]) == [0]
        assert arena.seg_words(0) == 0 and arena.n_segments == 2


def test_hub_without_device_raises_when_no_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstreaming.TenantHub(4)
