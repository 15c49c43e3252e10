"""The CUDA kernels on the card: each held exactly against its plain
version, the wrappers' no-fallback rule, and small mines through the
batched kernels at every granularity that reaches them. Every test here
is marked ``cuda`` and skips on a host without a CUDA device; run them
on the card with
``python -m pytest -m cuda tests/test_torch_cuda.py``. This file imports
no JAX, so it also collects where JAX is not installed."""
import collections

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.tidlist import (BitmapArena, from_device_words,
                                      pack_database, popcount32,
                                      to_device_words)
from repro_torch.kernels.bitmap_join import ops as bj
from repro_torch.kernels.bitmap_join.ref import (bitmap_join_many_ref,
                                                 bitmap_join_ref)
from repro_torch.kernels.gather_intersect import ops as gi
from repro_torch.kernels.gather_intersect.ref import (
    gather_intersect_many_ref, gather_intersect_many_rows_ref)
from repro_torch.kernels.bitmap_join.ref import bitmap_join_many_rows_ref
import _index_cases as cases

pytestmark = pytest.mark.cuda
RNG = np.random.default_rng(13)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def words(shape, dev):
    return to_device_words(
        RNG.integers(0, 2 ** 32, size=shape, dtype=np.uint32), dev)


def tids_batch(b, s, w, dev):
    """[b, s] sorted tids padded with -1: row 0 on bit 31s, row 1 all
    padding, the rest ragged."""
    tids = np.full((b, s), -1, np.int32)
    for i in range(b):
        if i == 1:
            continue
        if i == 0:
            t = np.arange(min(s, w)) * 32 + 31
        else:
            n = int(RNG.integers(0, min(s, 32 * w) + 1))
            t = np.sort(RNG.choice(32 * w, size=n, replace=False))
        tids[i, :len(t)] = t
    return torch.from_numpy(tids).to(dev)


@pytest.mark.parametrize("b,e,w", [(1, 1, 1), (3, 7, 33), (8, 64, 4096),
                                   (32, 512, 4096), (2, 9, 12292),
                                   (2, 9, 12301)])
def test_bitmap_join_many_kernel_matches_plain(cuda, b, e, w):
    p, x = words((b, w), cuda), words((b, e, w), cuda)
    n0 = bj.launches
    got = bj.bitmap_join_many(p, x)
    assert bj.launches == n0 + 1
    assert torch.equal(got, bitmap_join_many_ref(p, x))


# W % 4 != 0 (rows off the 16-byte grid), the T10I4D100K level-2 and
# kernels-bench shapes, W past one shared-memory chunk
@pytest.mark.parametrize("e,w", [(1, 1), (1, 3), (7, 33), (500, 3125),
                                 (513, 1025), (4096, 4096), (3, 12289),
                                 (9, 12301)])
def test_bitmap_join_kernel_matches_plain(cuda, e, w):
    p, x = words((w,), cuda), words((e, w), cuda)
    n0, m0 = bj.single_launches, bj.launches
    got = bj.bitmap_join(p, x)
    assert (bj.single_launches, bj.launches) == (n0 + 1, m0)
    assert torch.equal(got, bitmap_join_ref(p, x))


def test_bitmap_join_kernel_on_offset_rows_and_bit31_words(cuda):
    x = words((9, 37), cuda)[1:]             # base off the 16-byte grid
    p = torch.full((37,), -1, dtype=torch.int32, device=cuda)
    assert x.is_contiguous() and x.data_ptr() % 16
    assert torch.equal(bj.bitmap_join(p, x), bitmap_join_ref(p, x))
    ones = torch.full((5, 40), -1, dtype=torch.int32, device=cuda)
    assert bj.bitmap_join(ones[0], ones).tolist() == [40 * 32] * 5


@pytest.mark.parametrize("b,e,s,w", [(2, 1, 1, 2), (8, 64, 64, 4096),
                                     (32, 64, 8192, 4096),
                                     (3, 5, 9000, 400)])
def test_gather_intersect_many_kernel_matches_plain(cuda, b, e, s, w):
    t, x = tids_batch(b, s, w, cuda), words((b, e, w), cuda)
    n0 = gi.launches
    got = gi.gather_intersect_many(t, x)
    assert gi.launches == n0 + 1
    assert torch.equal(got, gather_intersect_many_ref(t, x))


# indexed entries: (n_rows, stride, n_words, B, E) — repeated handles,
# pad requests and lanes, n_words below the stride, rows off the 16-byte
# grid (odd stride), the mining path's phase-3 and phase-5 shapes over
# the mirror's pow2 stride, and the grid's y and z edges
@pytest.mark.parametrize("n_rows,stride,n_words,b,e", [
    (6, 8, 8, 3, 5), (20, 64, 33, 4, 9), (9, 3125, 3125, 2, 3),
    (300, 4096, 3125, 8, 256), (300, 4096, 3125, 1, 256),
    (40, 3125, 3125, 5, 257), (7, 4, 1, 65535, 1), (7, 4, 3, 1, 8 * 65535),
    (3, 12301, 12301, 2, 9), (3, 40000, 40000, 1, 2)])
def test_bitmap_join_many_rows_kernel_matches_plain(cuda, n_rows, stride,
                                                    n_words, b, e):
    rng = np.random.default_rng(n_rows + stride + b + e)
    m, pidx, eidx = cases.dense_case(rng, n_rows, stride, b, e)
    args = (to_device_words(m, cuda), torch.from_numpy(pidx).to(cuda),
            to_device_words(m, cuda), torch.from_numpy(eidx).to(cuda),
            n_words)
    n0 = bj.launches
    got = bj.bitmap_join_many_rows(*args)
    assert bj.launches == n0 + 1
    assert torch.equal(got, bitmap_join_many_rows_ref(*args))


# (n_rows, stride, n_words, B, E, S, tids past n_words): as above, S
# above one 256-tid tile, the phase-3 shape, B = 1 with E = 256, the
# grid's x, y and z edges
@pytest.mark.parametrize("n_rows,stride,n_words,b,e,s,past", [
    (6, 8, 8, 3, 5, 40, False), (20, 64, 33, 4, 9, 70, True),
    (9, 3125, 3125, 3, 3, 300, False), (300, 4096, 3125, 4, 64, 1024, False),
    (300, 4096, 3125, 1, 256, 2000, False),
    (40, 4096, 3125, 8, 65, 8192, False), (7, 4, 1, 65535, 1, 2, False),
    (7, 4, 3, 2, 8 * 65535, 3, False)])
def test_gather_intersect_many_rows_kernel_matches_plain(
        cuda, n_rows, stride, n_words, b, e, s, past):
    rng = np.random.default_rng(n_rows + stride + b + e + s)
    m, tids, lens, eidx = cases.sparse_case(rng, n_rows, stride, n_words,
                                            b, e, s, past_width=past)
    args = (torch.from_numpy(tids).to(cuda), torch.from_numpy(lens).to(cuda),
            to_device_words(m, cuda), torch.from_numpy(eidx).to(cuda),
            n_words)
    n0 = gi.launches
    got = gi.gather_intersect_many_rows(*args)
    assert gi.launches == n0 + 1
    assert torch.equal(got, gather_intersect_many_rows_ref(*args))


def test_gather_form_wrappers_match_indexed_entries(cuda):
    """The gathered form is the same kernel over identity indices."""
    rng = np.random.default_rng(5)
    m, pidx, eidx = cases.dense_case(rng, 50, 4096, 8, 64)
    p = to_device_words(cases.gathered_rows(m, pidx, 3125), cuda)
    x = to_device_words(cases.gathered_rows(m, eidx, 3125), cuda)
    store = to_device_words(m, cuda)
    pi, ei = (torch.from_numpy(a).to(cuda) for a in (pidx, eidx))
    assert torch.equal(bj.bitmap_join_many(p, x),
                       bj.bitmap_join_many_rows(store, pi, store, ei, 3125))
    m, tids, lens, eidx = cases.sparse_case(rng, 50, 4096, 3125, 4, 64, 600)
    t = torch.from_numpy(cases.gathered_tids(tids, lens)).to(cuda)
    x = to_device_words(cases.gathered_rows(m, eidx, 3125), cuda)
    store = to_device_words(m, cuda)
    assert torch.equal(gi.gather_intersect_many(t, x),
                       gi.gather_intersect_many_rows(
                           torch.from_numpy(tids).to(cuda),
                           torch.from_numpy(lens).to(cuda), store,
                           torch.from_numpy(eidx).to(cuda), 3125))


def test_indexed_entries_refuse_a_batch_past_the_grid(cuda):
    m = words((4, 8), cuda)
    idx = torch.zeros((1, 8 * 65535 + 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="grid"):
        bj.bitmap_join_many_rows(m, idx[:, 0], m, idx, 8)
    with pytest.raises(ValueError, match="grid"):
        gi.gather_intersect_many_rows(idx[:, :4].contiguous(), idx[:, 0], m,
                                      idx, 8)


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    x = words((2, 3, 8), cuda)
    strided = words((2, 16), cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        bj.bitmap_join_many(strided, x)
    with pytest.raises(ValueError, match="contiguous"):
        gi.gather_intersect_many(tids_batch(2, 16, 8, cuda)[:, ::2], x)
    with pytest.raises(ValueError, match="contiguous"):
        bj.bitmap_join(strided[0], x[0])


@pytest.mark.parametrize("granularity", ["bucket", "depth-first", "auto"])
def test_mine_on_card_matches_serial_through_both_kernels(cuda,
                                                          granularity):
    rng = np.random.default_rng(0)
    db = [sorted(rng.choice(40, size=rng.integers(1, 8),
                            replace=False).tolist()) for _ in range(4000)]
    bm, counts = pack_database(db, 40, return_counts=True)
    b0, g0 = bj.launches, gi.launches
    got, met = repro_torch.mine(bm, 40, max_k=4, item_counts=counts,
                                granularity=granularity)
    assert got == repro_torch.mine_serial(bm, 40, max_k=4)
    assert bj.launches > b0 and gi.launches > g0
    assert met.sparse_sweeps > 0 and met.dense_sweeps > 0


def _small_db(n_tx=4000, n_items=40):
    rng = np.random.default_rng(0)
    db = [sorted(rng.choice(n_items, size=rng.integers(1, 8),
                            replace=False).tolist()) for _ in range(n_tx)]
    return pack_database(db, n_items, return_counts=True)


def test_traced_bucket_mine_on_card(cuda):
    from repro_torch.obs import Tracer, check_nesting, time_in_state
    bm, counts = _small_db()
    tr = Tracer()
    got, met = repro_torch.mine(bm, 40, max_k=4, item_counts=counts,
                                trace=tr)
    assert got == repro_torch.mine_serial(bm, 40, max_k=4)
    assert tr.dropped() == 0
    assert check_nesting(tr.events()) == []
    names = tr.lane_names()
    assert {"driver", "dispatcher-0"} <= set(names)
    assert sum(n.startswith("worker-") for n in names) == 8
    cats = {e.cat for e in tr.events() if e.ph == "X"}
    assert {"task", "level", "flush", "sweep", "arena"} <= cats
    flushes = [e for e in tr.events() if e.name == "flush"]
    assert len(flushes) == met.flushes
    assert time_in_state(tr)


@pytest.mark.parametrize("backing", ["auto", "jax", "numpy"])
def test_mine_under_each_backing_on_card(cuda, monkeypatch, backing):
    """Every backing mines the serial supports through the CUDA kernels;
    without a mirror ("numpy") the sweeps launch the gathered forms and
    never the indexed entries, and no plain version runs."""
    from repro_torch.core import join_backend as jb
    calls = collections.Counter()

    def counted(module, name):
        fn = getattr(module, name)

        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        monkeypatch.setattr(module, name, wrapper)

    for name in ("bitmap_join_many", "gather_intersect_many",
                 "bitmap_join_many_rows", "gather_intersect_many_rows"):
        counted(jb, name)
    for module, name in ((bj, "bitmap_join_many_ref"),
                         (bj, "bitmap_join_many_rows_ref"),
                         (gi, "gather_intersect_many_ref"),
                         (gi, "gather_intersect_many_rows_ref")):
        counted(module, name)
    bm, counts = _small_db()
    b0, g0 = bj.launches, gi.launches
    got, met = repro_torch.mine(bm, 40, max_k=4, item_counts=counts,
                                arena=backing)
    assert got == repro_torch.mine_serial(bm, 40, max_k=4)
    assert not any(calls[n] for n in calls if n.endswith("_ref")), calls
    dense, sparse = (("bitmap_join_many", "gather_intersect_many")
                     if backing == "numpy" else
                     ("bitmap_join_many_rows", "gather_intersect_many_rows"))
    assert calls[dense] > 0 and calls[sparse] > 0, calls
    assert bj.launches - b0 == calls[dense]
    assert gi.launches - g0 == calls[sparse]
    other = {"bitmap_join_many", "gather_intersect_many",
             "bitmap_join_many_rows", "gather_intersect_many_rows"} - {
        dense, sparse}
    assert not any(calls[n] for n in other), calls
    if backing == "jax":
        assert met.h2d_bytes >= bm.nbytes


def test_launcher_on_card(cuda, capsys):
    from repro_torch.launch import fpm_mine
    fpm_mine.main(["--dataset", "mushroom", "--max-k", "3"])
    out = capsys.readouterr().out
    n = out.split("serial: ")[1].split()[0]
    lines = [ln for ln in out.splitlines()
             if ln.startswith(("cilk", "clustered"))]
    assert len(lines) == 2 and all(f"frequent={n}" in ln for ln in lines)
    assert "device=cuda" in out


# tuple prefixes: (n_rows, stride, n_words, B, E, L) — mixed tuple
# lengths with a pad request, a segment-width store of odd stride and
# one of 79 words, and the streaming phase's shapes (B up to 32 delta
# or query requests, pow2 segment strides of tens to hundreds of words)
@pytest.mark.parametrize("n_rows,stride,n_words,b,e,tuple_len", [
    (6, 8, 8, 3, 5, 2), (30, 79, 79, 5, 7, 8), (16, 333, 333, 4, 70, 3),
    (500, 128, 79, 32, 64, 7), (500, 512, 313, 32, 256, 3),
    (40, 4096, 3125, 4, 64, 2)])
def test_bitmap_join_many_rows_tuple_kernel_matches_plain(
        cuda, n_rows, stride, n_words, b, e, tuple_len):
    rng = np.random.default_rng(n_rows + stride + tuple_len)
    m, pidx, eidx = cases.tuple_case(rng, n_rows, stride, b, e, tuple_len)
    args = (to_device_words(m, cuda), torch.from_numpy(pidx).to(cuda),
            to_device_words(m, cuda), torch.from_numpy(eidx).to(cuda),
            n_words)
    n0 = bj.launches
    got = bj.bitmap_join_many_rows(*args)
    assert bj.launches == n0 + 1
    assert torch.equal(got, bitmap_join_many_rows_ref(*args))
    p = cases.gathered_tuple_prefixes(m, pidx, n_words)
    x = cases.gathered_rows(m, eidx, n_words)
    want = popcount32(p[:, None, :] & x).sum(axis=2)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_segment_mirrors_merge_on_card_after_compact(cuda):
    """Per-segment mirrors on the card, merged by compact: the merged
    mirror holds each live dense row's words at the merged width with
    zero pad words, and a sweep over it counts what the host does."""
    from repro_torch.core import join_backend as jb
    rng = np.random.default_rng(2)
    segs = [rng.integers(0, 2 ** 32, size=(12, w), dtype=np.uint32)
            for w in (37, 5, 11)]
    arena = BitmapArena.from_bitmaps(segs[0], device=cuda, backing="jax")
    h = arena.push(rng.integers(0, 2 ** 32, size=37, dtype=np.uint32))
    for s in segs[1:]:
        arena.add_segment(s)
    # eager: every segment's base rows; h covers segment 0 only and
    # reaches its mirror at the next sync
    assert arena.h2d_bytes == 12 * (37 + 5 + 11) * 4
    for g in range(3):
        arena.device_rows(segment=g)
    assert arena.h2d_bytes == 12 * (37 + 5 + 11) * 4 + 37 * 4
    assert arena.compact(3) == 2
    merged = arena.device_rows(0)
    assert merged.device.type == cuda.type and merged.shape[1] == 64
    host = from_device_words(merged[:, :53].contiguous())
    np.testing.assert_array_equal(host[:12], np.concatenate(segs, axis=1))
    np.testing.assert_array_equal(host[h], arena.row(h))
    assert not merged[:, 53:].any()
    reqs = [jb.SweepRequest((0, 1), (2, 3, h)), jb.SweepRequest(h, (4,))]
    got = jb.TorchBackend().sweep_many(arena, reqs)
    want = jb.NumpyBackend().sweep_many(arena, reqs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("granularity", ["bucket", "depth-first"])
def test_streaming_refresh_and_serving_on_card(cuda, granularity):
    """Ingest, refresh and serve on the card: every generation equals
    the serial miner, the dense kernel runs tuple prefixes, and device
    top-k equals the host ranking."""
    from repro_torch.core import streaming as ts
    rng = np.random.default_rng(4)
    txs = [sorted(rng.choice(40, size=rng.integers(2, 8),
                             replace=False).tolist()) for _ in range(1200)]
    sm = ts.StreamingMiner(40, 30, initial_db=txs[:1000], device=cuda,
                           max_k=4, arena="jax", granularity=granularity)
    try:
        sm.refresh()
        b0 = bj.launches
        for lo, hi in ((1000, 1100), (1100, 1200)):
            rep = sm.ingest(txs[lo:hi])
            assert rep.h2d_bytes == sm.arena.seg_nbytes(rep.segment)
            sm.refresh()
            full = pack_database(txs[:hi], 40)
            assert dict(sm.snapshot.supports) == repro_torch.mine_serial(
                full, 30, max_k=4)
        assert bj.launches > b0
        probes = [(0, 1, 2, 3, 4, 5), (7, 9, 11)]
        want = [sum(1 for t in txs if set(x) <= set(t)) for x in probes]
        assert sm.support_many(probes) == want
        snap = sm.snapshot
        host = snap.top_k((1,), 5)
        ts.TOPK_DEVICE_MIN, old = 0, ts.TOPK_DEVICE_MIN
        try:
            dev = ts.PatternSnapshot(snap.generation, snap.n_transactions,
                                     snap.min_support, snap.supports,
                                     device=cuda).top_k((1,), 5)
        finally:
            ts.TOPK_DEVICE_MIN = old
        assert dev == host
    finally:
        sm.close()


def _tie_heavy_supports():
    """The serving tests' tie-heavy supports: dense bands of equal
    supports among singletons, pairs and triples."""
    rng = np.random.default_rng(0)
    supports = {}
    for i in range(20):
        supports[(i,)] = 50 + int(rng.integers(0, 4))
    for i in range(12):
        for j in range(i + 1, 12):
            supports[(i, j)] = 10 + (i + j) % 5
    for x in [(0, 1, 2), (0, 1, 3), (0, 2, 5), (1, 2, 3), (2, 3, 4)]:
        supports[x] = 7
    return supports


@pytest.mark.parametrize("prefix,k", [
    ((), 10), ((), 1000), ((0,), 4), ((1,), 1), ((0, 1), 5),
    ((0, 1, 2), 3), ((9, 10, 11, 12), 2)])
def test_top_k_on_card_equals_host_on_ties(cuda, monkeypatch, prefix, k):
    """The device ranking on tie-heavy supports equals the host's
    stable order (equal supports rank lexicographically), and it ran
    on the card."""
    from repro_torch.core import streaming as ts
    supports = _tie_heavy_supports()
    host = ts.PatternSnapshot(1, 100, 2, supports, device="cpu").top_k(
        prefix, k)
    monkeypatch.setattr(ts, "TOPK_DEVICE_MIN", 0)
    snap = ts.PatternSnapshot(1, 100, 2, supports, device=cuda)
    assert snap.top_k(prefix, k) == host
    if len(prefix) < 3:
        assert snap._index._dev[0].is_cuda


def _peer_slice(dev):
    """A segmented slice (widths 37, 0 and 5 words) on ``dev``, with its
    words on the host."""
    segs = [RNG.integers(0, 2 ** 32, size=(24, w), dtype=np.uint32)
            for w in (37, 0, 5)]
    arena = BitmapArena.from_bitmaps(segs[0], device=dev)
    for s in segs[1:]:
        arena.add_segment(s)
    return arena, segs


def test_peer_evaluation_on_card_equals_host_evaluation(cuda):
    """Descriptor flushes with prefix tuples of 1 to 5 items and segment
    subsets, counted on a peer slice's mirror through the kernel backend
    (tuple-prefix launches of ``bitmap_join_many``), equal a host
    AND-popcount over the swept segments' words."""
    from repro_torch.core import cluster
    arena, segs = _peer_slice(cuda)
    descs = []
    for i in range(40):
        d = tuple(sorted(RNG.choice(24, size=1 + i % 5,
                                    replace=False).tolist()))
        e = tuple(RNG.choice(24, size=int(RNG.integers(1, 9)),
                             replace=False).tolist())
        descs.append((d, e, [None, (0,), (1, 2), (0, 1, 2), (2,)][i % 5]))
    n0 = bj.launches
    got = cluster._PeerEval(arena, "torch")(descs)
    assert bj.launches > n0
    for (d, e, sel), g in zip(descs, got):
        words = np.concatenate([segs[i] for i in (sel if sel is not None
                                                  else range(3))], axis=1)
        prefix = np.bitwise_and.reduce(words[list(d)], axis=0)
        assert np.array_equal(
            g, popcount32(words[list(e)] & prefix).sum(axis=1))


def _small_txns(n_tx):
    rng = np.random.default_rng(1)
    return [sorted(rng.choice(40, size=rng.integers(1, 8),
                              replace=False).tolist()) for _ in range(n_tx)]


@pytest.mark.parametrize("granularity", ["bucket", "depth-first"])
def test_cluster_mine_on_card_matches_serial(cuda, granularity):
    bm, _ = _small_db()
    ms = 120
    want = repro_torch.mine_serial(bm, ms, max_k=4)
    n0 = bj.launches
    got, met = repro_torch.mine(bm, ms, hosts=2, max_k=4,
                                granularity=granularity)
    assert got == want
    assert met.n_hosts == 2 and met.net_bytes > 0
    assert bj.launches > n0


def test_streaming_cluster_and_tenants_on_card(cuda):
    db = _small_txns(3000)
    ms = 90
    sm = repro_torch.StreamingMiner(40, ms, initial_db=db[:2000], hosts=2,
                                    max_k=3, arena="jax")
    try:
        sm.refresh()
        for lo in (2000, 2500):
            ing = sm.ingest(db[lo:lo + 500])
            assert ing.h2d_bytes == ing.payload_bytes
            sm.refresh()
        want = repro_torch.mine_serial(pack_database(db, 40), ms, max_k=3)
        assert dict(sm.snapshot.supports) == want
    finally:
        sm.close()
    with repro_torch.TenantHub(40, max_k=3) as hub:
        ta, tb = hub.tenant("a", 40, weight=4.0), hub.tenant("b", 40)
        ta.ingest(db[:1500])
        tb.ingest(db[1500:])
        hub.refresh_all()
        assert dict(ta.snapshot.supports) == repro_torch.mine_serial(
            pack_database(db[:1500], 40), 40, max_k=3)
        assert dict(tb.snapshot.supports) == repro_torch.mine_serial(
            pack_database(db[1500:], 40), 40, max_k=3)


def _shard_launches(monkeypatch):
    """Counts each batched indexed launch by the shard whose mirror the
    entry was handed: {(kernel, shard): launches}."""
    import threading
    from repro_torch.core import join_backend as jb
    seen, local = collections.Counter(), threading.local()
    sweep_many = jb.TorchBackend.sweep_many

    def swept(backend, arena, requests):
        local.arena = arena
        return sweep_many(backend, arena, requests)

    def spy(name):
        fn = getattr(jb, name)

        def call(*args):
            arena = local.arena
            owner = [s for s in range(arena.n_shards)
                     for m in arena._mirrors[s].values()
                     if m.data_ptr() == args[2].data_ptr()]
            assert len(owner) == 1
            if arena.devices is not None:
                assert args[2].device == arena.shard_device(owner[0])
            seen[(name, owner[0])] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(jb.TorchBackend, "sweep_many", swept)
    for name in ("bitmap_join_many_rows", "gather_intersect_many_rows"):
        monkeypatch.setattr(jb, name, spy(name))
    return seen


@pytest.mark.parametrize("granularity", ["bucket", "depth-first"])
def test_mesh_mine_on_card_launches_on_both_shard_mirrors(
        cuda, monkeypatch, granularity):
    bm, counts = _small_db()
    seen = _shard_launches(monkeypatch)
    got, met = repro_torch.mine(bm, 40, max_k=4, item_counts=counts,
                                granularity=granularity, mesh=2)
    assert got == repro_torch.mine_serial(bm, 40, max_k=4)
    assert met.n_devices == 2 and len(met.per_device) == 2
    assert all(d["flushes"] > 0 for d in met.per_device)
    for shard in (0, 1):
        assert seen[("bitmap_join_many_rows", shard)] > 0
        assert seen[("gather_intersect_many_rows", shard)] > 0
    assert met.d2d_bytes % 4 == 0


def test_sharded_device_rows_on_card_equal_cpu_arena(cuda):
    rows = RNG.integers(0, 2 ** 32, size=(6, 37), dtype=np.uint32)
    arenas = [BitmapArena.from_bitmaps(rows, device=d, n_shards=2)
              for d in (cuda, "cpu")]
    for a in arenas:
        h = a.materialize(0, 1, shard=0)
        t = a.push_tids(np.array([3, 64, 900], np.uint32), shard=0)
        a.device_rows(1, needed=[0, 2])
        a.migrate([a.materialize(2, 3, shard=0)], dst=1)
    got, want = (a.device_rows(1, needed=[h, t, 2]) for a in arenas)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    assert len({(a.d2d_bytes, a.h2d_bytes, a.migrations)
                for a in arenas}) == 1
    assert (from_device_words(got[h, :37].contiguous())
            == rows[0] & rows[1]).all()


def test_shard_dispatchers_stage_in_distinct_pinned_buffers(cuda):
    from repro_torch.core import fpm
    bm, counts = _small_db(2000)
    store = BitmapArena.from_bitmaps(bm, n_shards=2)
    run = fpm.MiningRun(store, policy="clustered", n_workers=4,
                        granularity="bucket", cache_size=8,
                        item_counts=counts)
    result, frequent = fpm._level1(bm, 40, counts=counts)
    try:
        fpm.mine_more(run, 40, 3, result, frequent)
    finally:
        run.close()
    backends = [d.backend for d in run.dispatchers]
    assert backends[0] is not backends[1]
    bufs = [b._stage for b in backends] + [b._counts for b in backends]
    assert all(buf.is_pinned() for buf in bufs)
    assert len({buf.data_ptr() for buf in bufs}) == 4


@pytest.fixture
def two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return [torch.device("cuda:0"), torch.device("cuda:1")]


@pytest.mark.parametrize("granularity", ["bucket", "candidate",
                                         "depth-first"])
def test_device_list_mesh_on_two_cards_matches_serial(
        two_cards, monkeypatch, granularity):
    """One shard per card: each shard's dispatcher thread launches on its
    own card's mirrors (the spy checks the mirror's device)."""
    bm, counts = _small_db()
    seen = _shard_launches(monkeypatch)
    got, met = repro_torch.mine(bm, 40, max_k=4, item_counts=counts,
                                granularity=granularity, mesh=two_cards)
    assert got == repro_torch.mine_serial(bm, 40, max_k=4)
    assert met.n_devices == 2 and all(d["flushes"] > 0
                                      for d in met.per_device)
    for shard in (0, 1):
        assert seen[("bitmap_join_many_rows", shard)] > 0


def test_device_list_arena_on_two_cards_equals_cpu_arena(two_cards):
    rows = RNG.integers(0, 2 ** 32, size=(6, 37), dtype=np.uint32)
    arenas = [BitmapArena.from_bitmaps(rows, device=d, n_shards=2,
                                       devices=ds)
              for d, ds in ((two_cards[0], two_cards), ("cpu", None))]
    for a in arenas:
        h = a.materialize(0, 1, shard=0)
        a.device_rows(1, needed=[0, 2])
        a.migrate([a.materialize(2, 3, shard=0)], dst=1)
    got, want = (a.device_rows(1, needed=[h, 2]) for a in arenas)
    assert got.device == two_cards[1]
    assert torch.equal(got.cpu(), want)
    got, want = (a.device_rows(0, needed=[h, 2]) for a in arenas)
    assert got.device == two_cards[0]
    assert torch.equal(got.cpu(), want)
    assert len({(a.d2d_bytes, a.h2d_bytes, a.migrations)
                for a in arenas}) == 1


def test_device_list_streaming_mesh_on_two_cards(two_cards):
    from repro_torch.core import streaming as ts
    rng = np.random.default_rng(4)
    txs = [sorted(rng.choice(40, size=rng.integers(2, 8),
                             replace=False).tolist()) for _ in range(1200)]
    sm = ts.StreamingMiner(40, 30, initial_db=txs[:1000], max_k=4,
                           arena="jax", mesh=two_cards)
    try:
        sm.refresh()
        sm.ingest(txs[1000:])
        sm.refresh()
        assert dict(sm.snapshot.supports) == repro_torch.mine_serial(
            pack_database(txs, 40), 30, max_k=4)
        probes = [(0, 1, 2, 3, 4, 5), (7, 9, 11)]
        assert sm.support_many(probes) == [
            sum(1 for t in txs if set(x) <= set(t)) for x in probes]
    finally:
        sm.close()


# ------------------------------------------------ the example scripts
def _example(name):
    import importlib
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]
                           / "examples"))
    return importlib.import_module(name)


def test_quickstart_example_on_card(cuda):
    """``examples/torch_quickstart.py`` on the card, chess cut to 400
    transactions at max_k=3: every run equals ``mine_serial`` (the script
    checks it) and the bucket and depth-first runs launch the dense
    kernel."""
    tq = _example("torch_quickstart")
    bj.launches = 0
    got = tq.run(n_transactions=400, max_k=3, out=lambda *_: None)
    assert bj.launches > 0
    met = {g: m for g, (_, m) in got["granularities"].items()}
    assert met["bucket"].flushes > 0 and met["depth-first"].flushes > 0
    assert met["depth-first"].cache_misses == 0
    assert got["serial"] == got["granularities"]["bucket"][0]


def test_distributed_example_on_card(cuda):
    """``examples/torch_distributed_mining.py`` on the card, mushroom cut
    to 400 transactions over eight shards (logical on a host with fewer
    cards): every mine equals ``mine_serial`` and each shard flushed."""
    tdm = _example("torch_distributed_mining")
    got = tdm.run(n_transactions=400, max_k=3, out=lambda *_: None)
    for res, met, _ in got["granularities"].values():
        assert res == got["serial"]
        assert met.n_devices == 8
        assert all(d["flushes"] > 0 for d in met.per_device)
    for res, stats, _ in got["policies"].values():
        assert res == got["serial"] and stats["n_devices"] == 8


def test_streaming_example_on_card(cuda):
    """``examples/torch_streaming_patterns.py`` on the card, retail cut to
    2,000 + 2 x 200 transactions at max_k=3: every generation equals
    ``mine_serial`` at its threshold, and ``support()`` of the top
    itemset equals a host count."""
    tsp = _example("torch_streaming_patterns")
    from repro_torch.data.transactions import load
    got = tsp.run(n_initial=2000, n_batches=2, batch_size=200, max_k=3,
                  out=lambda *_: None)
    db, prof = load("retail", seed=0)
    for rep, supports in got["generations"]:
        assert supports == repro_torch.mine_serial(
            pack_database(db[:rep.n_transactions], prof.n_items),
            rep.min_support, max_k=3)
    x = got["itemset"]
    assert got["support"] == sum(1 for t in db[:2400] if set(x) <= set(t))
