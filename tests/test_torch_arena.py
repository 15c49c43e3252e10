"""The port's arena against the reference's: the carry-across of bitmap
words between the packages, row lifecycle, sparse rows, and h2d billing
of the device mirror (here on the CPU)."""
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.core import tidlist as rtl
from repro_torch.core import tidlist as ttl
from repro_torch.core.tidlist import (BitmapArena, from_device_words,
                                      to_device_words)

RNG = np.random.default_rng(3)


def words(shape, rng=RNG):
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)


# -------------------------------------------------------- carry-across
def test_device_words_round_trip_bit_for_bit():
    x = np.concatenate([words((5, 7)),
                        np.array([[0x80000000, 0xFFFFFFFF, 0, 1,
                                   0x7FFFFFFF, 0x80000001, 2]],
                                 np.uint32)])
    t = to_device_words(x, "cpu")
    assert t.dtype == torch.int32 and t.shape == x.shape
    np.testing.assert_array_equal(t.numpy().view(np.uint32), x)
    back = from_device_words(t)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, x)
    with pytest.raises(TypeError):
        from_device_words(t.long())


@settings(max_examples=20, deadline=None, database=None)
@given(st.lists(st.integers(0, 2 ** 32 - 1), min_size=0, max_size=50))
def test_property_device_words_round_trip(xs):
    x = np.array(xs, np.uint32)
    np.testing.assert_array_equal(
        from_device_words(to_device_words(x, "cpu")), x)


def test_reference_bitmaps_carry_into_port_mirror():
    """The reference packs the database; the port's mirror holds the
    same words bit for bit."""
    db = [sorted(RNG.choice(9, size=RNG.integers(1, 6),
                            replace=False).tolist()) for _ in range(300)]
    bm = rtl.pack_database(db, 9)
    np.testing.assert_array_equal(ttl.pack_database(db, 9), bm)
    arena = BitmapArena.from_bitmaps(bm, device="cpu")
    mirror = arena.device_rows()
    assert mirror.shape == (9, arena.mirror_words)
    np.testing.assert_array_equal(
        from_device_words(mirror[:, :bm.shape[1]]), bm)
    assert not mirror[:, bm.shape[1]:].any()


def test_host_helpers_identical_to_reference():
    x = words((4, 13))
    np.testing.assert_array_equal(ttl.popcount32(x), rtl.popcount32(x))
    np.testing.assert_array_equal(ttl.support_counts(x[0], x[1:]),
                                  rtl.support_counts(x[0], x[1:]))
    assert ttl.support_of(x[:3]) == rtl.support_of(x[:3])
    tids = ttl.bitmap_to_tids(x[0])
    np.testing.assert_array_equal(tids, rtl.bitmap_to_tids(x[0]))
    np.testing.assert_array_equal(ttl.tids_to_bitmap(tids, 13), x[0])
    assert ttl.gather_count(tids, x[1]) == rtl.gather_count(tids, x[1])
    sub = ttl.bitmap_to_tids(x[0] & x[1])
    np.testing.assert_array_equal(ttl.sorted_difference(tids, sub),
                                  rtl.sorted_difference(tids, sub))


# ------------------------------------------------------------ lifecycle
def test_push_release_recycles_slots_and_pins_base():
    arena = BitmapArena.from_bitmaps(words((4, 3)), device="cpu")
    arena.release(0)                       # pinned: no-op
    assert arena.refcount(0) == 1
    h = arena.push(words(3))
    assert h == 4 and arena.live_extra == 1
    arena.retain(h)
    arena.release(h)
    assert arena.refcount(h) == 1
    arena.release(h)
    assert arena.live_extra == 0
    assert arena.push(words(3)) == h       # slot recycled
    assert arena.peak_live_extra == 1


def test_sparse_rows_densify_and_cascade_like_reference():
    rows = words((6, 4))
    arenas = (BitmapArena.from_bitmaps(rows, device="cpu"),
              rtl.BitmapArena.from_bitmaps(rows, backing="numpy"))
    pt = ttl.bitmap_to_tids(rows[0] & rows[1])
    sub = ttl.bitmap_to_tids(rows[0] & rows[1] & rows[2])
    out = []
    for a in arenas:
        ht = a.push_tids(pt)
        hd = a.push_diffset(ttl.sorted_difference(pt, sub), anchor=ht,
                            support=len(sub))
        hs = a.sparsify_push(rows[3] & rows[4])
        out.append((a.rep_of(ht), a.rep_of(hd), a.rep_of(hs),
                    a.densify(ht).tolist(), a.densify(hd).tolist(),
                    a.sparse_support(hd), a.refcount(ht)))
        a.release(ht)
        a.release(hd)                      # cascades to ht
        out.append((a.live_extra, a.sparse_live, a.sparse_bytes_live,
                    a.peak_sparse_bytes, a.densify_ops, a.sparsify_ops,
                    a.sparsify_bytes))
    assert out[0] == out[2] and out[1] == out[3]
    assert out[0][4] == (rows[0] & rows[1] & rows[2]).tolist()


# ----------------------------------------------------------- h2d billing
def test_mirror_h2d_billing_matches_reference():
    """The same push/release/sparse sequence with mirror syncs between
    steps bills the same h2d bytes as the reference's device mirror, and
    the mirror holds every live dense row (sparse slots zero)."""
    base = words((10, 9))
    port = BitmapArena.from_bitmaps(base, device="cpu")
    ref = rtl.BitmapArena.from_bitmaps(base, backing="auto")
    handles = []
    rng = np.random.default_rng(0)
    for step in range(40):
        op = rng.integers(0, 4)
        if op == 0 or not handles:
            row = words(9, rng)
            handles.append((port.push(row), ref.push(row)))
        elif op == 1:
            tids = np.sort(rng.choice(32 * 9, size=5, replace=False))
            handles.append((port.push_tids(tids), ref.push_tids(tids)))
        elif op == 2:
            hp, hr = handles.pop(int(rng.integers(len(handles))))
            port.release(hp)
            ref.release(hr)
        if step % 3 == 0:
            mirror = port.device_rows()
            ref.device_rows(0)
            assert port.h2d_bytes == ref.h2d_bytes, step
            for hp, _ in handles:
                if port.rep_of(hp) == ttl.REP_BITMAP:
                    np.testing.assert_array_equal(
                        from_device_words(mirror[hp, :9]), port.row(hp))
                else:
                    assert not mirror[hp].any()
    assert port.h2d_bytes > base.nbytes
    port.count_h2d(128)
    assert port.h2d_bytes == ref.h2d_bytes + 128


# ----------------------------------------------------------- device rule
def test_arena_without_device_raises_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BitmapArena.from_bitmaps(words((3, 2)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BitmapArena(4)
    assert BitmapArena(4, device="cpu").device == torch.device("cpu")


def test_arena_holds_one_shard_and_one_segment():
    """A loaded arena holds one segment until an ingest adds one; without
    ``n_shards`` it holds one shard, so no row can be owned by another,
    and a row cannot cover segments the arena does not have."""
    arena = BitmapArena.from_bitmaps(words((3, 2)), device="cpu")
    assert arena.n_segments == 1
    h = arena.push(words(2), shard=0, cover=1)
    assert arena.cover_of(h) == arena.cover_of(0) == 1
    with pytest.raises(ValueError, match="outside the arena's 1 shards"):
        arena.push(words(2), shard=1)
    with pytest.raises(ValueError, match="outside the arena's 1 segments"):
        arena.push_tids(np.array([1, 5], np.uint32), cover=2)
    with pytest.raises(ValueError, match="outside the arena's 1 shards"):
        arena.materialize(0, 1, shard=1)
    arena.add_segment(words((3, 1)))
    assert arena.n_segments == 2 and arena.cover_of(0) == 2
    assert arena.cover_of(h) == 1
    assert arena.cover_of(arena.push_tids(np.array([1], np.uint32),
                                          cover=2)) == 2


# ------------------------------------------------------- class handoffs
def test_class_handoffs_resolve_and_bill_like_reference():
    """The depth-first engine's arena calls on both arenas: a
    materialized row, a two-deep diffset chain resolved through its
    anchors, batched carve gathers, and the cascade of releases — rows,
    tid sets and every gauge agree."""
    rows = words((6, 5))
    arenas = (BitmapArena.from_bitmaps(rows, device="cpu"),
              rtl.BitmapArena.from_bitmaps(rows, backing="numpy"))
    t01 = ttl.bitmap_to_tids(rows[0] & rows[1])
    t012 = ttl.bitmap_to_tids(rows[0] & rows[1] & rows[2])
    t0123 = ttl.bitmap_to_tids(rows[0] & rows[1] & rows[2] & rows[3])
    out = []
    for a in arenas:
        hm = a.materialize(0, 1)
        ht = a.push_tids(t01)
        hd1 = a.push_diffset(ttl.sorted_difference(t01, t012), anchor=ht,
                             support=len(t012))
        hd2 = a.push_diffset(ttl.sorted_difference(t012, t0123),
                             anchor=hd1, support=len(t0123))
        resolved = [a.resolve_tids(h).tolist()
                    for h in (hm, ht, hd1, hd2)]
        bits = a.gather_bits_rows(t012, [3, 4, hm])
        gauges = [(a.live_extra, a.refcount(ht), a.refcount(hd1))]
        a.release(hd2)                     # cascades one release to hd1
        gauges.append((a.live_extra, a.refcount(ht), a.refcount(hd1)))
        a.release(hd1)                     # ... and on to ht
        a.release(ht)
        a.release(hm)
        gauges.append((a.live_extra, a.sparse_live, a.sparse_bytes_live))
        out.append((a.row(hm).tolist(), resolved, bits.tolist(),
                    a.anchor_of(hd2) == hd1, a.anchor_of(hm), gauges,
                    a.sparsify_ops, a.sparsify_bytes, a.densify_ops,
                    a.peak_live_extra))
    assert out[0] == out[1]
    row, resolved, bits = out[0][:3]
    assert row == (rows[0] & rows[1]).tolist()
    assert resolved == [t01.tolist(), t01.tolist(), t012.tolist(),
                        t0123.tolist()]
    assert out[0][6] == 1                  # the bitmap row's scan
    assert out[0][5][-1] == (0, 0, 0)
    assert np.array(bits).shape == (3, len(t012))


def test_gather_bits_matches_reference():
    x = words(7)
    tids = np.sort(RNG.choice(32 * 7, size=30, replace=False)
                   ).astype(np.uint32)
    np.testing.assert_array_equal(ttl.gather_bits(tids, x),
                                  rtl.gather_bits(tids, x))
    assert ttl.gather_bits(tids[:0], x).shape == (0,)


def test_materialized_rows_bill_h2d_like_reference():
    """Short-lived materialized rows in recycled slots, synced between
    steps: the mirror bills what the reference's mirror bills, and holds
    each live row's words."""
    base = words((8, 6))
    port = BitmapArena.from_bitmaps(base, device="cpu")
    ref = rtl.BitmapArena.from_bitmaps(base, backing="auto")
    live = []
    rng = np.random.default_rng(5)
    for step in range(60):
        if rng.random() < 0.55 or not live:
            p, e = (int(v) for v in rng.integers(0, 8, size=2))
            if live and rng.random() < 0.5:
                p = live[int(rng.integers(len(live)))][0]
            hp, hr = port.materialize(p, e), ref.materialize(p, e)
            assert hp == hr
            live.append((hp, hr))
        else:
            hp, hr = live.pop(int(rng.integers(len(live))))
            port.release(hp)
            ref.release(hr)
        if step % 4 == 0:
            mirror = port.device_rows()
            ref.device_rows(0)
            assert port.h2d_bytes == ref.h2d_bytes, step
            for hp, _ in live:
                np.testing.assert_array_equal(
                    from_device_words(mirror[hp, :6]), port.row(hp))
    assert port.h2d_bytes > base.nbytes
    assert port.peak_live_extra == ref.peak_live_extra


# ------------------------------------------------------------ residency
@pytest.mark.parametrize("backing", ["auto", "jax", "numpy"])
def test_backings_place_the_mirror_like_reference(backing):
    base = words((5, 3))
    port = BitmapArena.from_bitmaps(base, device="cpu", backing=backing)
    ref = rtl.BitmapArena.from_bitmaps(base, backing=backing)
    assert port.backing == backing
    assert port.device_enabled == ref.device_enabled == (backing != "numpy")
    assert port.h2d_bytes == ref.h2d_bytes == (
        5 * 3 * 4 if backing == "jax" else 0)
    mirror = port.device_rows()
    ref.device_rows()
    assert port.h2d_bytes == ref.h2d_bytes
    if backing == "numpy":
        assert mirror is None and port.h2d_bytes == 0
    else:
        np.testing.assert_array_equal(from_device_words(mirror[:, :3]), base)


def test_bad_backing_raises_value_error():
    for make in (lambda: BitmapArena(3, device="cpu", backing="cuda"),
                 lambda: BitmapArena.from_bitmaps(words((2, 2)),
                                                  device="cpu",
                                                  backing="torch")):
        with pytest.raises(ValueError, match="arena backing must be one of"):
            make()
    with pytest.raises(ValueError, match="arena backing"):
        rtl.BitmapArena(3, backing="cuda")
    assert ttl.ARENA_BACKINGS == rtl.ARENA_BACKINGS


@pytest.mark.parametrize("backing", ["jax", "numpy"])
def test_h2d_billing_per_backing_matches_reference(backing):
    """The same push/release/sparse/materialize sequence with mirror
    syncs between steps bills the reference's h2d bytes under the eager
    and the host-only backing (the lazy one: the two tests above)."""
    base = words((10, 9))
    port = BitmapArena.from_bitmaps(base, device="cpu", backing=backing)
    ref = rtl.BitmapArena.from_bitmaps(base, backing=backing)
    handles = []
    rng = np.random.default_rng(7)
    for step in range(40):
        op = rng.integers(0, 4)
        if op == 0 or not handles:
            row = words(9, rng)
            handles.append((port.push(row), ref.push(row)))
        elif op == 1:
            tids = np.sort(rng.choice(32 * 9, size=5, replace=False))
            handles.append((port.push_tids(tids), ref.push_tids(tids)))
        elif op == 2:
            hp, hr = handles.pop(int(rng.integers(len(handles))))
            port.release(hp)
            ref.release(hr)
        else:
            p, e = (int(v) for v in rng.integers(0, 10, size=2))
            handles.append((port.materialize(p, e), ref.materialize(p, e)))
        if step % 3 == 0:
            port.device_rows()
            ref.device_rows(0)
            assert port.h2d_bytes == ref.h2d_bytes, step
    port.count_h2d(96)
    ref.count_h2d(96)
    assert port.h2d_bytes == ref.h2d_bytes
    if backing == "numpy":
        assert port.h2d_bytes == 96


def test_new_helpers_equal_reference():
    bits = RNG.random((6, 75)) < 0.4
    np.testing.assert_array_equal(ttl.pack_bool(bits), rtl.pack_bool(bits))
    np.testing.assert_array_equal(
        ttl.unpack_bool(ttl.pack_bool(bits), 75), bits)
    db = [sorted(RNG.choice(7, size=RNG.integers(1, 5),
                            replace=False).tolist()) for _ in range(90)]
    port = BitmapArena.from_database(db, 7, device="cpu", backing="jax")
    ref = rtl.BitmapArena.from_database(db, 7, backing="jax")
    assert port.h2d_bytes == ref.h2d_bytes == port.nbytes_base
    assert port.nbytes_base == ref.nbytes_base
    out = []
    for a in (port, ref):
        hd = a.push(a.row(0) & a.row(1))
        ht = a.push_tids(np.array([1, 4, 9], np.uint32))
        out.append((a.gather([2, 3, 4]).tolist(),
                    a.gather([5, 0, hd]).tolist(),
                    a.rep_name(0), a.rep_name(ht), a.live_bytes_extra,
                    a.peak_bytes_extra))
        a.release(ht)
        out.append(a.live_bytes_extra)
    assert out[0] == out[2] and out[1] == out[3]
    assert out[0][2:4] == ("bitmap", "tidlist")
    arena = BitmapArena.from_bitmaps(words((4, 2)), device="cpu")
    assert arena.gather([1, 2]).base is not None     # a zero-copy slice


# ------------------------------------------------- mine under each backing
MINE_CASE = ("retail", 1000, 0.03, 3)     # sparse and dense sweeps


def _retail():
    from repro_torch.data import transactions as tt
    profile, n_tx, support, max_k = MINE_CASE
    db, p = tt.load(profile, 0)
    bm, counts = ttl.pack_database(db[:n_tx], p.n_items, return_counts=True)
    return bm, counts, max(1, int(support * n_tx)), max_k


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("backing", ["auto", "jax", "numpy"])
def test_mine_under_each_backing_equals_reference(backing, backend):
    """One worker fixes the schedule: supports and h2d bytes equal the
    reference's (its pallas-interpret run for the kernel backend, whose
    host-gather path bills each batch's rows under "numpy")."""
    from repro.core import fpm as rfpm
    from repro_torch.core import fpm as tfpm
    bm, counts, ms, max_k = _retail()
    got, gm = tfpm.mine(bm, ms, device="cpu", backend=backend,
                        arena=backing, n_workers=1, max_k=max_k,
                        item_counts=counts)
    want, wm = rfpm.mine(bm, ms, arena=backing, n_workers=1, max_k=max_k,
                         item_counts=counts,
                         backend=("pallas-interpret" if backend == "torch"
                                  else "numpy"))
    assert got == want
    assert gm.h2d_bytes == wm.h2d_bytes
    assert (gm.flushes, gm.sparse_sweeps, gm.dense_sweeps) == (
        wm.flushes, wm.sparse_sweeps, wm.dense_sweeps)
    assert gm.sparse_sweeps > 0 and gm.dense_sweeps > 0
    if backend == "numpy":
        assert gm.h2d_bytes == 0 or backing == "jax"
    elif backing == "numpy":
        # every batch re-ships its rows: far above one upload of the base
        assert gm.h2d_bytes > 4 * bm.nbytes


@pytest.mark.parametrize("backing", ["auto", "numpy"])
def test_kernel_backend_takes_the_gathered_forms_without_a_mirror(
        monkeypatch, backing):
    """With no mirror the kernel backend sweeps through the gathered
    forms (``[B', E', W]`` rows staged from the host) and never through
    the indexed entries; with a mirror, the other way round."""
    from repro_torch.core import fpm as tfpm
    from repro_torch.core import join_backend as tjb
    calls = {}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args)
        return wrapper

    for name in ("bitmap_join_many", "gather_intersect_many",
                 "bitmap_join_many_rows", "gather_intersect_many_rows"):
        monkeypatch.setattr(tjb, name, counted(name, getattr(tjb, name)))
    bm, counts, ms, max_k = _retail()
    got, met = tfpm.mine(bm, ms, device="cpu", arena=backing, n_workers=2,
                         max_k=max_k, item_counts=counts)
    assert got == tfpm.mine_serial(bm, ms, max_k=max_k)
    gathered = calls.get("bitmap_join_many", 0), calls.get(
        "gather_intersect_many", 0)
    indexed = calls.get("bitmap_join_many_rows", 0), calls.get(
        "gather_intersect_many_rows", 0)
    if backing == "numpy":
        assert min(gathered) > 0 and indexed == (0, 0)
    else:
        assert min(indexed) > 0 and gathered == (0, 0)
    assert sum(gathered) + sum(indexed) >= met.flushes


# ------------------------------------------------------------- segments
def mirrored_rows(port, seg):
    """Segment ``seg``'s mirror as uint32 rows at the segment's width."""
    return from_device_words(
        port.device_rows(segment=seg)[:, :port.seg_words(seg)].contiguous())


def test_segment_helpers_equal_reference():
    """add_segment, the seg_* accessors, coverage, row_upto, gather,
    rows_view and gather_bits_rows agree with the reference on a
    three-segment arena with rows pushed at every stage."""
    rng = np.random.default_rng(5)
    segs = [words((6, w), rng) for w in (4, 0, 3)]
    port = BitmapArena.from_bitmaps(segs[0], device="cpu")
    ref = rtl.BitmapArena.from_bitmaps(segs[0])
    hs = []
    for g in (1, 2):
        row = words(port.n_words, rng)
        hs.append((port.push(row), ref.push(row)))
        assert port.add_segment(segs[g], tenant="t") == \
            ref.add_segment(segs[g], tenant="t") == g
    row = words(7, rng)
    hs.append((port.push(row[:4], cover=1), ref.push(row[:4], cover=1)))
    tids = np.sort(rng.choice(32 * 7, size=20, replace=False)).astype(
        np.uint32)
    hs.append((port.push_tids(tids), ref.push_tids(tids)))
    hs.append((port.materialize(0, hs[1][0]), ref.materialize(0, hs[1][1])))
    assert [p for p, _ in hs] == [r for _, r in hs]
    for name in ("n_words", "n_segments", "n_rows"):
        assert getattr(port, name) == getattr(ref, name), name
    for g in range(3):
        assert port.seg_words(g) == ref.seg_words(g)
        assert port.seg_nbytes(g) == ref.seg_nbytes(g)
        assert port.seg_tid_range(g) == ref.seg_tid_range(g)
        assert port.seg_tenant(g) == ref.seg_tenant(g)
        np.testing.assert_array_equal(port.seg_view(g), ref.seg_view(g))
        np.testing.assert_array_equal(port.seg_gather(g, [5, 1, 2]),
                                      ref.seg_gather(g, [5, 1, 2]))
    assert port.tenant_segments("t") == ref.tenant_segments("t") == (1, 2)
    assert [port.n_words_upto(u) for u in range(4)] == \
        [ref.n_words_upto(u) for u in range(4)]
    for h, _ in hs:
        assert port.cover_of(h) == ref.cover_of(h)
        for u in (1, 2, 3):
            np.testing.assert_array_equal(port.row_upto(h, u),
                                          ref.row_upto(h, u))
        np.testing.assert_array_equal(port.row(h), ref.row(h))
    np.testing.assert_array_equal(port.gather([0, 3, 7]),
                                  ref.gather([0, 3, 7]))
    np.testing.assert_array_equal(port.rows_view(), ref.rows_view())
    np.testing.assert_array_equal(port.gather_bits_rows(tids, [0, 2, 6]),
                                  ref.gather_bits_rows(tids, [0, 2, 6]))
    assert port.resolve_tids(hs[0][0]).tolist() == \
        ref.resolve_tids(hs[0][1]).tolist()
    with pytest.raises(ValueError, match="n_base"):
        port.add_segment(words((5, 2), rng))


@pytest.mark.parametrize("backing", ["auto", "jax"])
def test_segment_mirrors_bill_and_merge_like_reference(backing):
    """Per-segment mirrors through ingest, lazy and eager syncs, slot
    recycling and two compactions: h2d_bytes equals the reference's at
    every step, an eager ingest bills exactly seg_nbytes, and every
    mirror holds the live dense rows' words at its segment's width
    (zeros for sparse, dead and uncovered rows)."""
    rng = np.random.default_rng(9)
    port = BitmapArena.from_bitmaps(words((8, 5), rng), device="cpu",
                                    backing=backing)
    ref = rtl.BitmapArena.from_bitmaps(words((8, 5), np.random.default_rng(
        9)), backing=backing)
    assert port.h2d_bytes == ref.h2d_bytes
    live = []
    for step in range(24):
        op = step % 6
        if op == 0:
            seg = words((8, int(rng.integers(1, 4))), rng)
            before = port.h2d_bytes
            g = port.add_segment(seg)
            assert ref.add_segment(seg) == g
            if backing == "jax":
                assert port.h2d_bytes - before == port.seg_nbytes(g)
        elif op in (1, 2):
            row = words(port.n_words, rng)
            cov = port.n_segments - (op == 2 and port.n_segments > 1)
            live.append((port.push(row[:port.n_words_upto(cov)], cover=cov),
                         ref.push(row[:ref.n_words_upto(cov)], cover=cov)))
        elif op == 3 and live:
            hp, hr = live.pop(0)
            port.release(hp)
            ref.release(hr)
        elif op == 4:
            tids = np.sort(rng.choice(32 * port.n_words, size=4,
                                      replace=False)).astype(np.uint32)
            live.append((port.push_tids(tids), ref.push_tids(tids)))
        else:
            up = int(rng.integers(2, port.n_segments + 1))
            assert port.compact(up) == ref.compact(up)
            assert port.compaction_bytes == ref.compaction_bytes
        for g in range(port.n_segments):
            if step % 2 or g % 2 == 0:       # syncs land unevenly
                mirrored_rows(port, g)
                ref.device_rows(0, segment=g)
        assert port.h2d_bytes == ref.h2d_bytes, step
    assert port.compactions == ref.compactions > 0
    for g in range(port.n_segments):
        m = mirrored_rows(port, g)
        assert m.shape == (port.n_rows, port.seg_words(g))
        assert port.device_rows(segment=g).shape[1] == port.seg_mirror_words(g)
        for hp, _ in live:
            if port.rep_of(hp) == ttl.REP_BITMAP:
                np.testing.assert_array_equal(m[hp], port.seg_row(g, hp))
            else:
                assert not m[hp].any()
        # the pad words past the segment's width stay zero after merges
        assert not port.device_rows(segment=g)[:, port.seg_words(g):].any()
    assert port.h2d_bytes == ref.h2d_bytes
