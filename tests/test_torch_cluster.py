"""The port's multi-host mining against the reference's on the same
seeded data (``device="cpu"``): word partitioning, the loopback cluster
at every granularity and policy, three hosts, a forced cross-host steal,
the merged metrics, the streaming cluster, the deterministic billing of
one-request flushes, peer evaluation through both backends against
the reference's, and a real two-process mine over a TCPStore. Exact
equality throughout: supports are integers."""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import repro.core.cluster as rcluster
from repro.core.fpm import mine as rmine
from repro.core.streaming import StreamingMiner as RStreamingMiner
from repro.core.tidlist import BitmapArena as RArena
from repro.core.tidlist import pack_database as rpack
from repro.core.tidlist import partition_words as rpartition
from repro_torch.core import cluster as tcluster
from repro_torch.core.fpm import mine
from repro_torch.core.streaming import StreamingMiner
from repro_torch.core.tidlist import (BitmapArena, pack_database,
                                      partition_words, popcount32)

ROOT = Path(__file__).resolve().parents[1]
N_ITEMS = 24


def _db(n_tx, seed, lo=2, hi=9):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(N_ITEMS, size=int(rng.integers(lo, hi)),
                              replace=False).tolist())
            for _ in range(n_tx)]


def ref_mine(bm, ms, **kw):
    return rmine(bm, ms, backend="numpy", **kw)


def test_partition_words_properties():
    for n_w in [0, 1, 2, 7, 64, 157, 4062]:
        for n in [1, 2, 3, 5, 8]:
            ranges = partition_words(n_w, n)
            assert ranges == rpartition(n_w, n)
            assert len(ranges) == n
            # contiguous cover, in order, each slice within one word of fair
            assert ranges[0][0] == 0 and ranges[-1][1] == n_w
            for (a0, b0), (a1, b1) in zip(ranges, ranges[1:]):
                assert b0 == a1
            widths = [b - a for a, b in ranges]
            assert max(widths) - min(widths) <= 1
    with pytest.raises(ValueError):
        partition_words(4, 0)


@pytest.mark.parametrize("granularity",
                         ["bucket", "candidate", "depth-first"])
@pytest.mark.parametrize("policy", ["clustered", "fifo"])
def test_cluster_bit_matches_single_host(granularity, policy):
    bm = pack_database(_db(1500, 3), N_ITEMS)
    ms = 75
    ref, base = ref_mine(bm, ms, granularity=granularity, max_k=5)
    res, met = mine(bm, ms, hosts=2, device="cpu", policy=policy,
                    granularity=granularity, max_k=5, n_workers=3)
    assert res == ref
    assert met.n_hosts == 2
    # every flush crossed the (loopback) interconnect
    assert met.net_bytes > 0
    assert len(met.per_host) == 2
    assert all(h["bytes_swept"] > 0 for h in met.per_host)
    assert all(h["eval_bytes"] > 0 for h in met.per_host)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_cluster_three_hosts(backend):
    bm = pack_database(_db(2000, 11), N_ITEMS)
    ms = 100
    ref, _ = ref_mine(bm, ms, max_k=5)
    res, met = tcluster.mine_cluster(bm, ms, hosts=3, device="cpu",
                                     max_k=5, n_workers=2, backend=backend)
    assert res == ref
    assert met.n_hosts == 3 and len(met.per_host) == 3


def test_cluster_forced_steal_migrates_buckets():
    """owner_fn pins every bucket on host 0; host 1 only makes progress
    through cross-host steal-as-migration. The race depends on timing on
    a shared-core runner, so the run repeats until a migration lands."""
    bm = pack_database(_db(12000, 5, lo=3), N_ITEMS)
    ms = 600
    ref, _ = ref_mine(bm, ms, granularity="bucket", max_k=4, n_workers=4)
    for _ in range(5):
        res, met = tcluster.mine_cluster(bm, ms, hosts=2, device="cpu",
                                         granularity="bucket", max_k=4,
                                         n_workers=4,
                                         owner_fn=lambda key: 0)
        assert res == ref
        if met.cross_steals > 0:
            break
    assert met.cross_steals > 0
    assert met.steal_net > 0  # migrated buckets billed in bytes


def test_merge_metrics_sums_and_maxes():
    bm = pack_database(_db(800, 7), N_ITEMS)
    _, m0 = mine(bm, 40, max_k=4, device="cpu")
    res, met = tcluster.mine_cluster(bm, 40, hosts=2, device="cpu",
                                     max_k=4, n_workers=2)
    _, rmet = rcluster.mine_cluster(bm, 40, hosts=2, max_k=4, n_workers=2)
    # swept bytes sum over hosts; each host sweeps its own slice
    assert met.bytes_swept == sum(h["bytes_swept"] for h in met.per_host)
    assert met.candidates == m0.candidates == rmet.candidates
    assert met.frequent == m0.frequent == rmet.frequent == len(res)
    assert met.flushes == sum(r["flushes"] for r in met.per_device)
    assert sorted(r["host"] for r in met.per_device) == [0, 1]
    assert met.batch_occupancy > 0
    # merging is a pure function of the per-host rows and the gauges
    g = tcluster.ClusterGauges(2)
    g.net_bytes, g.eval_bytes = 7, [3, 4]
    again = tcluster.merge_metrics([m0, m0], g, "depth-first")
    assert (again.candidates, again.frequent) == (2 * m0.candidates,
                                                  2 * m0.frequent)
    assert again.wall_s == m0.wall_s and again.net_bytes == 7
    assert [h["eval_bytes"] for h in again.per_host] == [3, 4]


@pytest.mark.parametrize("granularity", ["bucket", "depth-first"])
@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_one_request_flushes_bill_as_the_reference(granularity, backend):
    """One worker per host and ``max_batch=1``: every flush is one
    request, so the descriptor traffic (``net_bytes`` less the steal
    migrations), each host's ``eval_bytes``, ``rows_touched`` and
    ``bytes_swept`` follow from the data alone and equal the reference's.
    Cross-host steals still happen (an idle host takes a peer's bucket),
    and how many follows the thread timing, so ``steal_net`` is set
    apart."""
    bm = pack_database(_db(1500, 3), N_ITEMS)
    kw = dict(hosts=2, granularity=granularity, max_k=5, n_workers=1,
              max_batch=1)
    got, gm = tcluster.mine_cluster(bm, 75, device="cpu", backend=backend,
                                    **kw)
    want, wm = rcluster.mine_cluster(bm, 75, backend="numpy", **kw)
    assert got == want
    assert gm.net_bytes - gm.steal_net == wm.net_bytes - wm.steal_net > 0
    assert ([h["eval_bytes"] for h in gm.per_host]
            == [h["eval_bytes"] for h in wm.per_host])
    for gauge in ("rows_touched", "bytes_swept", "flushes", "buckets",
                  "candidates", "frequent"):
        assert getattr(gm, gauge) == getattr(wm, gauge), gauge
    assert gm.batch_occupancy == 1.0


def _peer_arenas(seed):
    """The same segmented slice in both packages: three segments, one
    of zero width (a peer's twin of an ingest it does not own)."""
    rng = np.random.default_rng(seed)
    segs = [rng.integers(0, 2 ** 32, size=(N_ITEMS, w), dtype=np.uint32)
            for w in (37, 0, 5)]
    port = BitmapArena.from_bitmaps(segs[0], device="cpu")
    ref = RArena.from_bitmaps(segs[0])
    for s in segs[1:]:
        port.add_segment(s)
        ref.add_segment(s)
    return port, ref, np.concatenate(segs, axis=1)


def test_peer_evaluation_on_kernel_backend_equals_host_evaluation():
    """A descriptor flush — prefix tuples of 1 to 5 items, extension
    lists, segment subsets or all segments — counted on a peer slice
    through the kernel backend (tuple-prefix requests, the kernel's plain
    version on a CPU arena) and through the host backend equals the
    reference's evaluation and an AND-popcount over the slice's
    words."""
    port, ref, words = _peer_arenas(3)
    rng = np.random.default_rng(4)
    descs = []
    for i in range(40):
        d = tuple(sorted(rng.choice(N_ITEMS, size=1 + i % 5,
                                    replace=False).tolist()))
        e = tuple(rng.choice(N_ITEMS, size=int(rng.integers(1, 9)),
                             replace=False).tolist())
        segs = [None, (0,), (1, 2), (0, 1, 2), (2,)][i % 5]
        descs.append((d, e, segs))
    kernel = tcluster._PeerEval(port, "torch")(descs)
    host = tcluster._PeerEval(port, "numpy")(descs)
    reference = rcluster._eval_descs(ref, descs, {})
    bounds = np.cumsum([0, 37, 0, 5])
    for (d, e, segs), k, h, r in zip(descs, kernel, host, reference):
        cols = np.concatenate([np.arange(bounds[g], bounds[g + 1])
                               for g in (segs if segs is not None
                                         else range(3))]).astype(int)
        prefix = np.bitwise_and.reduce(words[list(d)][:, cols], axis=0)
        want = popcount32(words[list(e)][:, cols] & prefix).sum(axis=1)
        for got in (k, h, r):
            assert np.array_equal(got, want)
    assert (tcluster._eval_rows_bytes(descs, port)
            == rcluster._eval_rows_bytes(descs, ref))
    assert tcluster._desc_nbytes(descs) == rcluster._desc_nbytes(descs)


def test_streaming_cluster_matches_batch():
    init, b1, b2 = _db(400, 21), _db(150, 22), _db(200, 23)
    kw = dict(initial_db=init, hosts=2, n_workers=2, max_k=4, arena="jax")
    sm = StreamingMiner(N_ITEMS, 25, device="cpu", **kw)
    rsm = RStreamingMiner(N_ITEMS, 25, **kw)
    try:
        db = list(init)
        for b in (b1, b2):
            # each ingest bills its payload on the owner host only
            h0 = [ar.h2d_bytes for ar in sm._harenas]
            rh0 = [ar.h2d_bytes for ar in rsm._harenas]
            ing, ring = sm.ingest(b), rsm.ingest(b)
            billed = [ar.h2d_bytes - h for ar, h in zip(sm._harenas, h0)]
            assert billed == [ar.h2d_bytes - h
                              for ar, h in zip(rsm._harenas, rh0)]
            assert sorted(billed) == [0, ing.payload_bytes]
            assert (ing.segment, ing.words, ing.payload_bytes,
                    ing.h2d_bytes) == (ring.segment, ring.words,
                                       ring.payload_bytes, ring.h2d_bytes)
            db += b
            rep = sm.refresh()
            rsm.refresh()
        ref, _ = ref_mine(pack_database(db, N_ITEMS), 25, max_k=4)
        assert dict(sm.snapshot.supports) == ref == dict(
            rsm.snapshot.supports)
        assert rep.metrics.n_hosts == 2
        assert rep.metrics.net_bytes > 0
        assert rep.compacted_segments == 0 and sm.compact_now() == 0
        g = sm.cluster_gauges
        assert g is not None and g["net_bytes"] > 0
        assert g["reduced_flushes"] > 0
        # ingest routed segments to both host arenas
        assert all(ar.n_words > 0 for ar in sm._harenas)
        assert ([ar.seg_words(s) for ar in sm._harenas for s in (1, 2)]
                == [ar.seg_words(s) for ar in rsm._harenas for s in (1, 2)])
        # queries reduce across host slices and stay exact
        bm = pack_database(db, N_ITEMS)
        for q in ([0, 1, 2], [5, 9], [1, 3, 5, 7, 9, 11]):
            want = int(popcount32(np.bitwise_and.reduce(bm[q], axis=0)).sum())
            assert sm.support_many([q])[0] == want
    finally:
        sm.close()
        rsm.close()


def test_streaming_single_host_has_no_gauges():
    sm = StreamingMiner(N_ITEMS, 25, initial_db=_db(200, 31), device="cpu")
    try:
        assert sm.cluster_gauges is None
    finally:
        sm.close()


def test_streaming_cluster_rejects_mesh_and_diffsets():
    with pytest.raises(ValueError, match="bitmap"):
        StreamingMiner(N_ITEMS, 5, hosts=2, representation="sparse",
                       device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        StreamingMiner(N_ITEMS, 5, hosts=2, mesh=2, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        mine(np.ones((3, 2), np.uint32), 1, hosts=2, mesh=2, device="cpu")
    with pytest.raises(ValueError, match="hosts >= 2"):
        tcluster.mine_cluster(np.ones((3, 2), np.uint32), 1, hosts=1,
                              device="cpu")


# ---------------------------------------------------------------------------
# a real two-process mine over a TCPStore (rank 0 hosts the store)

DIST_CODE = """
import json, sys
from repro_torch.core.cluster import mine_distributed_process
from repro_torch.core.tidlist import pack_database
rank = int(sys.argv[1]); n = int(sys.argv[2]); coord = sys.argv[3]
db = json.loads(sys.argv[4])
res, met = mine_distributed_process(
    pack_database(db, 24), 45, rank=rank, n_procs=n, coordinator=coord,
    max_k=4, n_workers=2, device="cpu")
print(json.dumps({"rank": rank, "supports": sorted(
                      [list(c), v] for c, v in res.items()),
                  "n_hosts": met.n_hosts, "net_bytes": met.net_bytes,
                  "flushes": met.flushes}))
"""


@pytest.mark.timeout(120)
def test_two_process_distributed_bit_matches():
    """Two rank processes over a TCPStore that rank 0 hosts: each rank
    holds the same supports as the reference's single-host mine of the
    reference test's 900 x 24 data."""
    rng = np.random.default_rng(9)
    db = [sorted(rng.choice(24, size=int(rng.integers(2, 8)),
                            replace=False).tolist()) for _ in range(900)]
    want, _ = ref_mine(rpack(db, 24), 45, max_k=4)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(DIST_CODE), str(r), "2",
         coord, json.dumps(db)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=100)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [o["rank"] for o in outs] == [0, 1]
    assert len(want) > 24
    for o in outs:
        assert {tuple(c): v for c, v in o["supports"]} == want
        assert o["n_hosts"] == 2 and o["net_bytes"] > 0 and o["flushes"] > 0
