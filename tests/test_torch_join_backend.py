"""The port's join backends and sweep dispatcher: numpy and kernel
backends against naive counts and against the reference's backends
(counts and h2d billing), and the dispatcher's coalescing, timeout and
error semantics."""
import threading

import numpy as np
import pytest
import torch

from repro.core import join_backend as rjb
from repro.core import tidlist as rtl
from repro_torch.core import join_backend as jb
from repro_torch.core import tidlist
from repro_torch.core.tidlist import BitmapArena

RNG = np.random.default_rng(7)


def rand_rows(n_rows, w, rng=RNG):
    return rng.integers(0, 2 ** 32, size=(n_rows, w), dtype=np.uint32)


def naive_counts(prefix, exts):
    return np.array([sum(bin(int(prefix[w]) & int(exts[i, w])).count("1")
                         for w in range(len(prefix)))
                     for i in range(exts.shape[0])], dtype=np.int64)


def mixed_arena(rows, mod_arena, **kw):
    """Arena over ``rows`` plus a tid-list and a diffset row; returns the
    arena and the (dense prefix, sparse prefix) bitmaps each stands for."""
    arena = mod_arena.from_bitmaps(rows, **kw)
    pt = tidlist.bitmap_to_tids(rows[0] & rows[1])
    ht = arena.push_tids(pt)
    sub = tidlist.bitmap_to_tids(rows[0] & rows[1] & rows[2])
    hd = arena.push_diffset(tidlist.sorted_difference(pt, sub), anchor=ht,
                            support=len(sub))
    return arena, ht, hd


SPECS = [(0, range(1, 12)),          # wide
         (3, [7]),                   # single extension
         (11, [0, 2, 4, 6, 8, 10]),  # strided
         (5, range(6, 9))]           # narrow


# ------------------------------------------------------------- backends
@pytest.mark.parametrize("name", ["numpy", "torch"])
def test_backend_matches_naive_on_ragged_mixed_batch(name):
    rows = rand_rows(12, 40)
    arena, ht, hd = mixed_arena(rows, BitmapArena, device="cpu")
    specs = SPECS + [(ht, (3, 4, 5)), (hd, (3, 4, 5))]
    reqs = [jb.SweepRequest(p, tuple(e)) for p, e in specs]
    got = jb.resolve_backend(name).sweep_many(arena, reqs)
    for (p, e), c in zip(SPECS, got):
        np.testing.assert_array_equal(c, naive_counts(rows[p],
                                                      rows[list(e)]))
        assert c.dtype == np.int64
    both = naive_counts(rows[0] & rows[1], rows[3:6])
    diff = naive_counts(rows[0] & rows[1] & ~rows[2], rows[3:6])
    np.testing.assert_array_equal(got[-2], both)
    np.testing.assert_array_equal(got[-1], diff)


def test_torch_backend_matches_reference_pallas_backend_and_h2d():
    """Same arena contents, same flushes: the kernel backend's counts
    and h2d bill equal the reference pallas-interpret backend's."""
    rows = rand_rows(12, 40)
    port, pht, phd = mixed_arena(rows, BitmapArena, device="cpu")
    ref, rht, rhd = mixed_arena(rows, rtl.BitmapArena, backing="auto")
    assert (pht, phd) == (rht, rhd)
    for flush in (SPECS, [(pht, (1, 2)), (0, (5,)), (phd, (3, 9, 10))]):
        a = jb.TorchBackend().sweep_many(
            port, [jb.SweepRequest(p, tuple(e)) for p, e in flush])
        b = rjb.get_backend("pallas-interpret").sweep_many(
            ref, [rjb.SweepRequest(p, tuple(e)) for p, e in flush])
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert port.h2d_bytes == ref.h2d_bytes
    assert port.h2d_bytes > 0


def test_torch_backend_hands_the_mirror_itself_to_the_indexed_entries(
        monkeypatch):
    """Each flush makes at most one launch per representation, and every
    launch gets the arena's mirror itself (same storage and shape, not a
    gathered copy) with int32 indices: the real batch, pad lanes -1."""
    rows = rand_rows(12, 40)
    arena, ht, hd = mixed_arena(rows, BitmapArena, device="cpu")
    calls = []

    def recording(name, fn, index_args):
        def entry(*args):
            # index tensors are views of the backend's reused staging
            # buffer, refilled by the next launch: keep copies
            calls.append((name, [a.clone() if i in index_args else a
                                 for i, a in enumerate(args)]))
            return fn(*args)
        return entry

    monkeypatch.setattr(jb, "bitmap_join_many_rows", recording(
        "dense", jb.bitmap_join_many_rows, (1, 3)))
    monkeypatch.setattr(jb, "gather_intersect_many_rows", recording(
        "sparse", jb.gather_intersect_many_rows, (0, 1, 3)))
    backend = jb.TorchBackend()
    for flush in (SPECS + [(ht, (3, 4, 5)), (hd, (3, 9))], SPECS[:2],
                  [(hd, (1, 2, 4, 6, 8, 10))]):
        calls.clear()
        reqs = [jb.SweepRequest(p, tuple(e)) for p, e in flush]
        for c, want in zip(backend.sweep_many(arena, reqs),
                           jb.NumpyBackend().sweep_many(arena, reqs)):
            np.testing.assert_array_equal(c, want)
        dense = [(p, e) for p, e in flush if p < len(rows)]
        sparse = [(p, e) for p, e in flush if p >= len(rows)]
        assert [n for n, _ in calls] == (["dense"] * bool(dense)
                                         + ["sparse"] * bool(sparse))
        mirror = arena.device_rows()
        for name, args in calls:
            part = dense if name == "dense" else sparse
            stores = (args[0], args[2]) if name == "dense" else (args[2],)
            eidx = args[3]
            for st in stores:
                assert st.data_ptr() == mirror.data_ptr()
                assert st.shape == mirror.shape
            assert args[4] == arena.n_words
            want = np.full((len(part), max(len(e) for _, e in part)), -1)
            for i, (_, e) in enumerate(part):
                want[i, :len(e)] = e
            assert eidx.dtype == torch.int32
            np.testing.assert_array_equal(eidx.numpy(), want)
            if name == "dense":
                assert args[1].tolist() == [p for p, _ in part]
            else:
                lens = [len(arena.tids_of(p)) for p, _ in part]
                assert args[1].tolist() == lens
                assert args[0].shape == (len(part), max(1, max(lens)))


def test_numpy_backend_matches_reference_numpy_backend():
    rows = rand_rows(20, 17)
    port = BitmapArena.from_bitmaps(rows, device="cpu")
    ref = rtl.BitmapArena.from_bitmaps(rows, backing="numpy")
    flush = [(p, tuple(RNG.choice(20, size=RNG.integers(1, 9),
                                  replace=False).tolist()))
             for p in range(20)]
    a = jb.NumpyBackend().sweep_many(
        port, [jb.SweepRequest(p, e) for p, e in flush])
    b = rjb.NumpyBackend().sweep_many(
        ref, [rjb.SweepRequest(p, e) for p, e in flush])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert port.h2d_bytes == ref.h2d_bytes == 0


def test_resolve_backend():
    assert jb.resolve_backend("auto").name == "torch"
    assert jb.resolve_backend("numpy").name == "numpy"
    with pytest.raises(ValueError, match="unknown join backend"):
        jb.resolve_backend("pallas-jit")


# ----------------------------------------------------------- dispatcher
def test_dispatcher_coalesces_full_batch():
    rows = rand_rows(9, 6)
    arena = BitmapArena.from_bitmaps(rows, device="cpu")
    disp = jb.SweepDispatcher(arena, jb.TorchBackend(), n_clients=4,
                              flush_us=500_000)
    try:
        futs = [disp.submit(p, tuple(range(p + 1, 9))) for p in range(4)]
        for p, f in enumerate(futs):
            np.testing.assert_array_equal(
                f.result(timeout=10), naive_counts(rows[p], rows[p + 1:]))
        assert disp.flushes == 1 and disp.batch_occupancy == 4.0
        assert disp.stats()["sweep_requests"] == 4
    finally:
        disp.stop()


def test_dispatcher_partial_flush_on_timeout():
    rows = rand_rows(4, 3)
    arena = BitmapArena.from_bitmaps(rows, device="cpu")
    disp = jb.SweepDispatcher(arena, jb.TorchBackend(), n_clients=8,
                              flush_us=1_000)
    try:
        got = disp.sweep(0, (1, 2, 3))
        np.testing.assert_array_equal(got, naive_counts(rows[0], rows[1:]))
        assert disp.flushes == 1 and disp.batch_occupancy == 1.0
    finally:
        disp.stop()


def test_dispatcher_error_resolves_every_future():
    class Bomb(jb.JoinBackend):
        def sweep_many(self, arena, requests):
            raise RuntimeError("batch boom")

    arena = BitmapArena.from_bitmaps(rand_rows(4, 3), device="cpu")
    disp = jb.SweepDispatcher(arena, Bomb(), n_clients=2, flush_us=200_000)
    try:
        futs = [disp.submit(0, (1,)), disp.submit(1, (2, 3))]
        for f in futs:
            with pytest.raises(RuntimeError, match="batch boom"):
                f.result(timeout=10)
    finally:
        disp.stop()


def test_dispatcher_concurrent_clients_agree_with_serial():
    rows = rand_rows(20, 10)
    arena = BitmapArena.from_bitmaps(rows, device="cpu")
    disp = jb.SweepDispatcher(arena, jb.TorchBackend(), n_clients=6)
    errs = []

    def client(p):
        try:
            exts = tuple(i for i in range(20) if i != p)
            for _ in range(5):
                np.testing.assert_array_equal(
                    disp.sweep(p, exts),
                    naive_counts(rows[p], rows[list(exts)]))
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=client, args=(p,))
               for p in range(6)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        disp.stop()
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    assert disp.requests == 30


def test_dispatcher_submit_after_stop_raises():
    arena = BitmapArena.from_bitmaps(rand_rows(2, 2), device="cpu")
    disp = jb.SweepDispatcher(arena, jb.TorchBackend(), n_clients=1)
    disp.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        disp.submit(0, (1,))


# ------------------------------------------------------------ sweep_bits
def test_sweep_bits_inline_on_numpy_backend_matches_reference():
    """A sparse prefix on the host backend: (counts, bits) from one
    gather on the calling thread, equal to the reference dispatcher's,
    billed as one 1-request flush that never went through the queue."""
    rows = rand_rows(12, 40)
    port, pht, phd = mixed_arena(rows, BitmapArena, device="cpu")
    ref, rht, rhd = mixed_arena(rows, rtl.BitmapArena, backing="numpy")
    pd = jb.SweepDispatcher(port, jb.NumpyBackend(), n_clients=1)
    rd = rjb.SweepDispatcher(ref, rjb.NumpyBackend(), n_clients=1)
    try:
        for h in (pht, phd, 2):
            counts, bits = pd.sweep_bits(h, (3, 4, 5))
            want, wbits = rd.sweep_bits(h, (3, 4, 5))
            np.testing.assert_array_equal(counts, want)
            assert counts.dtype == np.int64
            if h == 2:                     # dense prefix: no bit matrix
                assert bits is None and wbits is None
                continue
            np.testing.assert_array_equal(bits, wbits)
            assert bits.shape == (3, len(port.tids_of(h)))
            np.testing.assert_array_equal(bits.sum(axis=1), counts)
        np.testing.assert_array_equal(
            pd.sweep_bits(pht, (3, 4, 5))[0],
            naive_counts(rows[0] & rows[1], rows[3:6]))
        assert (pd.flushes, pd.requests) == (4, 4)
        st = pd.stats()
        assert st["queue_flushes"] == 0 and st["batch_occupancy"] == 1.0
        assert st == {**rd.stats(), "flushes": 4, "sweep_requests": 4,
                      "batch_occupancy": 1.0, "sweep_s": st["sweep_s"]}
    finally:
        pd.stop()
        rd.stop()


def test_sweep_bits_on_torch_backend_takes_the_queue():
    rows = rand_rows(12, 40)
    arena, ht, hd = mixed_arena(rows, BitmapArena, device="cpu")
    disp = jb.SweepDispatcher(arena, jb.TorchBackend(), n_clients=1)
    try:
        counts, bits = disp.sweep_bits(ht, (3, 4, 5))
        assert bits is None
        np.testing.assert_array_equal(
            counts, naive_counts(rows[0] & rows[1], rows[3:6]))
        counts, bits = disp.sweep_bits(0, (1, 2))
        assert bits is None
        np.testing.assert_array_equal(counts,
                                      naive_counts(rows[0], rows[1:3]))
        st = disp.stats()
        assert st["flushes"] == st["queue_flushes"] == 2
        assert st["sweep_requests"] == st["queue_requests"] == 2
    finally:
        disp.stop()


def test_sweep_bits_after_stop_raises():
    arena = BitmapArena.from_bitmaps(rand_rows(2, 2), device="cpu")
    disp = jb.SweepDispatcher(arena, jb.NumpyBackend(), n_clients=1)
    disp.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        disp.sweep_bits(0, (1,))


def test_backend_registry(monkeypatch):
    """``get_backend`` builds a fresh backend per call (a kernel backend's
    staging buffers belong to one dispatcher); ``available_backends``
    lists the kernel backend with a card, or when the CPU is asked for."""
    assert isinstance(jb.get_backend("numpy"), jb.NumpyBackend)
    assert isinstance(jb.get_backend("torch"), jb.TorchBackend)
    assert jb.get_backend("torch") is not jb.get_backend("torch")
    assert isinstance(jb.resolve_backend("auto"), jb.TorchBackend)
    with pytest.raises(ValueError, match="unknown join backend"):
        jb.get_backend("pallas-jit")
    with pytest.raises(ValueError, match="unknown join backend"):
        rjb.get_backend("torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert jb.available_backends() == ["numpy"]
    assert jb.available_backends(device="cpu") == ["numpy", "torch"]
    assert jb.available_backends(device="cuda") == ["numpy"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert jb.available_backends() == ["numpy", "torch"]


def test_host_gather_sweep_bills_like_reference():
    """A mirror-less arena: the kernel backend's host-gather sweeps give
    the naive counts and bill the reference's pallas-interpret h2d for
    the same mixed dense/sparse flush."""
    rows = rand_rows(12, 7)
    port = BitmapArena.from_bitmaps(rows, device="cpu", backing="numpy")
    ref = rtl.BitmapArena.from_bitmaps(rows, backing="numpy")
    tids = tidlist.bitmap_to_tids(rows[0] & rows[1])
    hp, hr = port.push_tids(tids), ref.push_tids(tids)
    reqs = [(0, (1, 2, 3)), (5, (6,)), ("sparse", (4, 7, 8, 9, 10))]
    got = jb.TorchBackend().sweep_many(port, [
        jb.SweepRequest(hp if p == "sparse" else p, e) for p, e in reqs])
    want = rjb.get_backend("pallas-interpret").sweep_many(ref, [
        rjb.SweepRequest(hr if p == "sparse" else p, e) for p, e in reqs])
    for g, w, (p, e) in zip(got, want, reqs):
        np.testing.assert_array_equal(g, w)
        prefix = (tidlist.tids_to_bitmap(tids, 7) if p == "sparse"
                  else rows[p])
        np.testing.assert_array_equal(g, naive_counts(prefix, rows[list(e)]))
    assert port.h2d_bytes == ref.h2d_bytes > 0


# ------------------------------------------------ segments and tuples
def segmented_pair(backing):
    """Port and reference arenas built by the same calls: 10 base rows
    over three segments (widths 5, 3 and 2 words), a dense row pushed
    before the last segment (it covers two), and a tid-list whose tids
    span the three segments' windows."""
    rng = np.random.default_rng(3)
    segs = [rand_rows(10, w, rng) for w in (5, 3, 2)]
    port = BitmapArena.from_bitmaps(segs[0], device="cpu", backing=backing)
    ref = rtl.BitmapArena.from_bitmaps(segs[0], backing=backing)
    for a in (port, ref):
        a.add_segment(segs[1])
    row = rand_rows(1, 8, rng)[0]
    hd = (port.push(row), ref.push(row))
    for a in (port, ref):
        a.add_segment(segs[2])
    tids = np.sort(rng.choice(32 * 10, size=60, replace=False)).astype(
        np.uint32)
    ht = (port.push_tids(tids), ref.push_tids(tids))
    assert hd[0] == hd[1] and ht[0] == ht[1]
    return port, ref, hd[0], ht[0]


def segment_flushes(hd, ht):
    """Flushes of ``(prefix, exts, segments)``: tuple prefixes of mixed
    lengths, single rows, a two-segment row, a sparse prefix across
    segment boundaries, and segment subsets."""
    return [
        [((0, 1), (2, 3, 4), None), (5, (6, 7), None),
         ((1, 2, 3), (0, 9), None), (ht, (1, 2, 3, 4), None)],
        [((0, 1), (2, 3), (2,)), ((4, 5, 6), (7,), (1, 2)),
         (hd, (0, 1, 2), (0, 1)), (ht, (5, 6), (1,)),
         (3, (8,), (0, 2))],
        [(hd, (4, 5), None), (ht, (0,), (0, 2)), ((2, 3), (9,), (1,))],
    ]


@pytest.mark.parametrize("backing", ["auto", "jax", "numpy"])
def test_torch_backend_segments_and_tuples_match_reference(backing):
    """Tuple prefixes, segment subsets and sparse prefixes across
    segment boundaries, on a segmented arena and again after
    compaction: the kernel backend's counts and h2d bill equal the
    reference's pallas-interpret backend flush by flush, and the counts
    equal the numpy backend's."""
    port, ref, hd, ht = segmented_pair(backing)
    backend = jb.TorchBackend()
    for stage in ("segmented", "compacted"):
        if stage == "compacted":
            assert port.compact(2) == ref.compact(2) == 1
            assert port.compaction_bytes == ref.compaction_bytes > 0
            assert port.n_segments == ref.n_segments == 2
        for flush in segment_flushes(hd, ht):
            if stage == "compacted":
                # segment ids shift down by one past the merged block
                flush = [(p, e, None if s is None
                          else tuple(sorted({max(0, g - 1) for g in s})))
                         for p, e, s in flush]
            got = backend.sweep_many(port, [
                jb.SweepRequest(p, e, segments=s) for p, e, s in flush])
            want = rjb.get_backend("pallas-interpret").sweep_many(ref, [
                rjb.SweepRequest(p, e, segments=s) for p, e, s in flush])
            host = jb.NumpyBackend().sweep_many(port, [
                jb.SweepRequest(p, e, segments=s) for p, e, s in flush])
            for g, w, h in zip(got, want, host):
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g, h)
            assert port.h2d_bytes == ref.h2d_bytes, (stage, flush)
    assert port.h2d_bytes > 0


def test_torch_backend_launches_once_per_segment_and_representation(
        monkeypatch):
    """A flush over a three-segment arena makes one dense and one
    sparse launch per segment it touches, each on that segment's
    mirror at its width; tuple prefixes arrive as [B, L] rows with -1
    past each tuple's end, single-row batches as [B]."""
    port, _, hd, ht = segmented_pair("auto")
    calls = []
    # index tensors are views of the reused staging buffer: keep copies
    for name, index_args in (("bitmap_join_many_rows", (1, 3)),
                             ("gather_intersect_many_rows", (0, 1, 3))):
        fn = getattr(jb, name)

        def entry(*args, _fn=fn, _name=name, _idx=index_args):
            calls.append((_name, [a.clone() if i in _idx else a
                                  for i, a in enumerate(args)]))
            return _fn(*args)
        monkeypatch.setattr(jb, name, entry)
    backend = jb.TorchBackend()
    backend.sweep_many(port, [jb.SweepRequest((0, 1, 2), (3, 4)),
                              jb.SweepRequest(5, (6,)),
                              jb.SweepRequest(ht, (7, 8))])
    assert [n for n, _ in calls] == ["bitmap_join_many_rows",
                                     "gather_intersect_many_rows"] * 3
    for g in range(3):
        (_, dense), (_, sparse) = calls[2 * g], calls[2 * g + 1]
        mirror = port.device_rows(segment=g)
        assert dense[0].data_ptr() == mirror.data_ptr()
        assert dense[0].shape[1] == port.seg_mirror_words(g)
        assert dense[4] == sparse[4] == port.seg_words(g)
        assert dense[1].tolist() == [[0, 1, 2], [5, -1, -1]]
    calls.clear()
    backend.sweep_many(port, [jb.SweepRequest(5, (6,), segments=(1,))])
    assert len(calls) == 1 and calls[0][1][1].tolist() == [5]


@pytest.mark.parametrize("name", ["numpy", "torch"])
def test_dispatcher_bursts_match_reference(name):
    """``submit_many`` (priority bursts jump the queue in order) and
    ``sweep_local`` (inline on the host backend, queued on the kernel
    backend) give the reference's counts over a segmented arena."""
    port, ref, hd, ht = segmented_pair("auto")
    sweeps = [((0, 1), (2, 3)), (hd, (4,)), (ht, (5, 6, 7)), (3, (9,))]
    disp = jb.SweepDispatcher(port, jb.resolve_backend(name), n_clients=1)
    rdisp = rjb.SweepDispatcher(ref, rjb.get_backend("numpy"), n_clients=1)
    try:
        for segs in (None, (1, 2)):
            got = disp.sweep_local(sweeps, segments=segs)
            want = rdisp.sweep_local(sweeps, segments=segs)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            futs = disp.submit_many(sweeps, segments=segs, priority=True)
            for f, w in zip(futs, want):
                np.testing.assert_array_equal(f.result(timeout=10), w)
        assert disp.query_requests == 2 * len(sweeps)
        assert disp.sweep_local([]) == []
    finally:
        disp.stop()
        rdisp.stop()
