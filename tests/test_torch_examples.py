"""The port's three example scripts (``examples/torch_*.py``) against the
same sequences driven through the reference package, on the same seeded
data and knobs (``device="cpu"``, the kernel backend): the quickstart
(chess, each policy at candidate grain, then each granularity), the
eight-shard mushroom mesh (``mine(mesh=)`` at two grains, then
``mine_distributed`` under both policies) and the retail stream under a
fraction threshold (ingest, top-3, refresh). Every mine's supports
equal the reference's, and every generation equals ``mine_serial`` (the
reference's stream falls short of it where its known counts go stale;
see the stream test). The gauges that a one-worker schedule fixes are
exact too. The mesh cannot run one worker (each of its eight shards gets
one), so there only the gauges that no schedule moves are held exactly,
and the rest by their structure."""
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import distributed_fpm as rdist
from repro.core import fpm as rfpm
from repro.core import streaming as rs
from repro.core.tidlist import pack_database as rpack
from repro.core.tidlist import popcount32
from repro.data.transactions import load as rload

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
import torch_distributed_mining as tdm  # noqa: E402
import torch_quickstart as tq  # noqa: E402
import torch_streaming_patterns as tsp  # noqa: E402

# gauges that one worker fixes, on every granularity of the quickstart
QUICK_GAUGES = ("rows_touched", "bytes_swept", "candidates", "frequent",
                "levels", "buckets", "cache_hits", "cache_misses",
                "cache_partial_hits", "dense_sweeps", "sparse_sweeps",
                "flushes", "peak_retained_bitmaps")
REFRESH_GAUGES = ("generation", "n_transactions", "min_support", "frequent",
                  "segments_refreshed", "dirty_items", "stayed", "born",
                  "died", "reused", "swept_delta", "swept_full",
                  "rows_touched", "bytes_swept", "compacted_segments",
                  "compaction_bytes")


def quiet(*_):
    pass


def test_quickstart_matches_reference():
    """Chess cut to 800 transactions at max_k=3, one worker: every mine's
    supports, and each run's locality gauges (cache hits, rows, tasks),
    equal the reference's."""
    n_tx, max_k = 800, 3
    got = tq.run("cpu", backend="torch", n_transactions=n_tx, max_k=max_k,
                 n_workers=1, out=quiet)
    db, prof = rload("chess", seed=0)
    db = db[:n_tx]
    bm = rpack(db, prof.n_dense_items)
    ms = int(prof.support * len(db))
    ref = rfpm.mine_serial(bm, ms, max_k=max_k)
    assert got["min_support"] == ms
    assert got["serial"] == ref and len(ref) > 1000
    runs = [(got["policies"][p], ("candidate", p)) for p in tq.POLICIES]
    runs += [(got["granularities"][g], (g, "clustered"))
             for g in tq.GRANULARITIES]
    wanted = {}
    for (res, met), key in runs:
        if key not in wanted:
            wanted[key] = rfpm.mine(bm, ms, backend="numpy", n_workers=1,
                                    max_k=max_k, granularity=key[0],
                                    policy=key[1])
        want, wmet = wanted[key]
        kw = dict(granularity=key[0], policy=key[1])
        assert res == want == ref, kw
        # the Cilk-style worker pops its newest task while the level is
        # still being spawned (in both packages), so which prefix is
        # cached when follows the thread timing; the probes do not
        gauges = QUICK_GAUGES if kw["policy"] == "clustered" else (
            "candidates", "frequent", "levels", "flushes")
        if kw["granularity"] == "depth-first":
            # the reference's numpy backend keeps every handoff row a
            # bitmap; its kernel backend, like the port's, makes some
            # diffsets, which read other bytes from the same rows
            gauges = [g for g in gauges if g not in (
                "bytes_swept", "dense_sweeps", "sparse_sweeps")]
        for g in gauges:
            assert getattr(met, g) == getattr(wmet, g), (kw, g)
        assert met.cache_hits + met.cache_misses == \
            wmet.cache_hits + wmet.cache_misses
        for g in ("tasks_run", "steals"):
            assert met.scheduler[g] == wmet.scheduler[g], (kw, g)
    # the paper's locality claim: clustered candidates reuse prefixes
    cilk, clustered = (got["policies"][p][1] for p in ("cilk", "clustered"))
    assert clustered.cache_hit_rate > cilk.cache_hit_rate
    assert got["granularities"]["depth-first"][1].cache_misses == 0


def test_distributed_mining_matches_reference():
    """Mushroom cut to 800 transactions at max_k=3 over eight logical
    shards, eight workers: supports of all four mines, and the gauges no
    schedule moves — candidates, levels, frequent, shards, and at bucket
    grain and through ``mine_distributed`` no cross-shard traffic — equal the
    reference's; round_robin (no cache, every candidate its full join)
    reads exactly the reference's rows. Which worker steals decides the
    cached-prefix rows and the depth-first handoff traffic, so those
    are held by structure: clustered reads fewer rows than round_robin,
    and depth-first bills whole migrated or fetched rows."""
    n_tx, shards, max_k = 800, tdm.N_SHARDS, 3
    got = tdm.run("cpu", backend="torch", n_transactions=n_tx, max_k=max_k,
                  out=quiet)
    db, p = rload("mushroom", seed=0)
    db = db[:n_tx]
    bm = rpack(db, p.n_dense_items)
    ms = int(0.22 * len(db))
    ref = rfpm.mine_serial(bm, ms, max_k=max_k)
    assert got["min_support"] == ms and got["serial"] == ref
    for gran in tdm.GRANULARITIES:
        res, met, _ = got["granularities"][gran]
        want, wmet = rfpm.mine(bm, ms, mesh=shards, granularity=gran,
                               policy="clustered", n_workers=tdm.N_WORKERS,
                               max_k=max_k, backend="numpy")
        assert res == want == ref, gran
        for g in ("candidates", "levels", "frequent", "n_devices"):
            assert getattr(met, g) == getattr(wmet, g), (gran, g)
        assert met.n_devices == len(met.per_device) == shards
        assert all(d["flushes"] > 0 for d in met.per_device), gran
        if gran == "bucket":
            assert (met.d2d_bytes, met.migrations) == (
                wmet.d2d_bytes, wmet.migrations) == (0, 0)
        else:
            assert met.cache_misses == wmet.cache_misses == 0
            assert met.d2d_bytes % (bm.shape[1] * 4) == 0
            assert met.migrations * bm.shape[1] * 4 <= met.d2d_bytes
    rows = {}
    for pol in tdm.POLICIES:
        res, stats, _ = got["policies"][pol]
        want, wstats = rdist.mine_distributed(bm, ms, shards, policy=pol,
                                              max_k=max_k, backend="numpy")
        assert res == want == ref, pol
        assert set(stats) == set(wstats)
        for key in ("levels", "candidates", "n_devices", "d2d_bytes",
                    "migrations"):
            assert stats[key] == wstats[key], (pol, key)
        assert (stats["d2d_bytes"], stats["migrations"]) == (0, 0)
        rows[pol] = stats["rows_touched"], wstats["rows_touched"]
    assert rows["round_robin"][0] == rows["round_robin"][1]
    assert rows["clustered"][0] < rows["round_robin"][0]


def _exact(known, bitmaps):
    """Whether every entry of a streaming miner's known store equals its
    support over ``bitmaps`` (the refreshed transactions)."""
    by_len = {}
    for x, s in known.items():
        by_len.setdefault(len(x), []).append((x, s))
    for entries in by_len.values():
        items = np.array([x for x, _ in entries])
        rows = np.bitwise_and.reduce(bitmaps[items], axis=1)
        if not np.array_equal(popcount32(rows).sum(axis=1),
                              [s for _, s in entries]):
            return False
    return True


def test_streaming_patterns_matches_reference():
    """Retail: 3,000 transactions mined, then two ingests of 300 under the
    script's fraction threshold, one worker. Every generation's supports
    equal ``mine_serial`` at that generation's threshold, and the border
    moves both ways. The ingests' bytes, the top-3 answers and the last
    ``support()`` equal the reference's, and so do a generation's
    supports and every report gauge while the reference's known store
    is exact when the refresh starts.

    Here it is not: at generation 2 a subset of (0, 186, 224) dies, the
    reference keeps that candidate's count without the new segment, and
    at generation 3 it misses two frequent itemsets. The port drops such
    counts and sweeps the candidates in full when they return (see
    ``test_stale_returning_candidate_is_the_known_divergence`` in
    ``test_torch_streaming.py``), so from there on it is held to
    ``mine_serial`` and the reference's supports to a subset of it."""
    n0, batches, size, max_k = 3000, 2, 300, 3
    got = tsp.run("cpu", backend="torch", n_initial=n0, n_batches=batches,
                  batch_size=size, n_workers=1, max_k=max_k, out=quiet)
    db, prof = rload("retail", seed=0)
    ref = rs.StreamingMiner(prof.n_items, prof.support, initial_db=db[:n0],
                            backend="numpy", n_workers=1, max_k=max_k)
    server = rs.PatternServer(ref)
    exact, reps, snaps, tops, ingests = [], [], [], [], []
    try:
        for i in range(batches + 1):
            if i:
                ingests.append(ref.ingest(
                    db[n0 + (i - 1) * size:n0 + i * size]))
                tops.append(server.top_k((), 3))
            n = n0 + i * size if i else n0
            exact.append(i == 0 or _exact(ref._known, rpack(
                db[:ref.snapshot.n_transactions], prof.n_items)))
            reps.append(ref.refresh())
            snaps.append(dict(ref.snapshot.supports))
            assert ref.snapshot.n_transactions == n
        itemset = server.top_k((), 1)[0][0]
        support = server.support(itemset)
    finally:
        ref.close()
    assert len(got["generations"]) == len(reps) == batches + 1
    prev = {}
    for (rep, supports), rrep, rsup, ok in zip(got["generations"], reps,
                                               snaps, exact):
        truth = rfpm.mine_serial(rpack(db[:rep.n_transactions],
                                       prof.n_items),
                                 rep.min_support, max_k=max_k)
        assert supports == truth, rep.generation
        assert rsup.items() <= truth.items()
        assert rep.frequent == len(truth)
        assert (rep.born, rep.died) == (len(truth.keys() - prev.keys()),
                                        len(prev.keys() - truth.keys()))
        if ok:
            assert supports == rsup, rep.generation
            for g in REFRESH_GAUGES:
                assert getattr(rep, g) == getattr(rrep, g), (
                    rep.generation, g)
        prev = truth
    assert all(r.born > 0 and r.died > 0
               for r, _ in got["generations"][1:])
    for ing, ring in zip(got["ingests"], ingests):
        assert (ing.segment, ing.n_transactions, ing.words,
                ing.payload_bytes, ing.h2d_bytes) == (
            ring.segment, ring.n_transactions, ring.words,
            ring.payload_bytes, ring.h2d_bytes)
    assert got["top3"] == tops
    assert (got["itemset"], got["support"]) == (itemset, support)


@pytest.mark.parametrize("script", [tq, tdm, tsp])
def test_main_without_device_raises_without_cuda(script, monkeypatch):
    """Without a card and without ``--device cpu`` each script raises the
    port's RuntimeError before it builds any data."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main([])
