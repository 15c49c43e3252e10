"""The kernels' plain PyTorch versions against the reference's Pallas
kernels (interpret mode) and jnp oracles, and the wrappers' device rule.
The indexed entries (row store + int32 indices) are held against the
reference's kernels on the gathered equivalent of the same inputs.

Counts are integers, so every comparison is exact. The CUDA kernels are
held against these plain versions on the card in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.kernels.bitmap_join.kernel import (bitmap_join_kernel,
                                              bitmap_join_many_kernel)
from repro.kernels.bitmap_join.ops import bitmap_join as r_single_ops
from repro.kernels.bitmap_join.ops import bitmap_join_many as r_join_ops
from repro.kernels.bitmap_join.ref import bitmap_join_many_ref as r_join_ref
from repro.kernels.bitmap_join.ref import bitmap_join_ref as r_single_ref
from repro.kernels.gather_intersect.kernel import (
    gather_intersect_many_kernel)
from repro.kernels.gather_intersect.ops import (
    gather_intersect_many as r_gather_ops)
from repro.kernels.gather_intersect.ref import (
    gather_intersect_many_np, gather_intersect_many_ref as r_gather_ref)
from repro_torch.core.tidlist import to_device_words
from repro_torch.kernels.bitmap_join import ops as bj
from repro_torch.kernels.bitmap_join.ref import (bitmap_join_many_ref,
                                                 bitmap_join_many_rows_ref,
                                                 bitmap_join_ref, popcount32)
from repro_torch.kernels.gather_intersect import ops as gi
from repro_torch.kernels.gather_intersect.ref import (
    gather_intersect_many_ref, gather_intersect_many_rows_ref)
import _index_cases as cases

RNG = np.random.default_rng(11)
SPECIAL = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x55555555,
                    0xAAAAAAAA, 0x0F0F0F0F, 0xF0F0F0F0, 0x80000001],
                   np.uint32)


def words(shape, rng=RNG):
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)


def t32(a):
    return to_device_words(a, "cpu")


def tids_batch(b, s, w, rng=RNG, empty_rows=()):
    """[b, s] sorted tids padded with -1; row 0 sits on bit 31s."""
    tids = np.full((b, s), -1, np.int32)
    for i in range(b):
        if i in empty_rows or s == 0:
            continue
        if i == 0:
            t = np.arange(min(s, w)) * 32 + 31
        else:
            n = int(rng.integers(0, min(s, 32 * w) + 1))
            t = np.sort(rng.choice(32 * w, size=n, replace=False))
        tids[i, :len(t)] = t
    return tids


# -------------------------------------------------------------- popcount
def test_popcount32_matches_numpy_on_special_and_random_words():
    x = np.concatenate([SPECIAL, words(5000)])
    got = popcount32(t32(x)).numpy()
    np.testing.assert_array_equal(got, np.bitwise_count(x))


@settings(max_examples=30, deadline=None, database=None)
@given(st.lists(st.integers(0, 2 ** 32 - 1), min_size=1, max_size=64))
def test_property_popcount32(xs):
    x = np.array(xs, np.uint32)
    np.testing.assert_array_equal(popcount32(t32(x)).numpy(),
                                  np.bitwise_count(x))


# ------------------------------------------------------ bitmap_join_many
@pytest.mark.parametrize("b,e,w", [(1, 1, 1), (3, 7, 33), (2, 64, 512),
                                   (5, 70, 600), (4, 1, 12)])
def test_bitmap_join_many_plain_matches_reference(b, e, w):
    p, x = words((b, w)), words((b, e, w))
    p[0, :min(w, len(SPECIAL))] = SPECIAL[:w]
    got = bitmap_join_many_ref(t32(p), t32(x)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, np.asarray(r_join_ref(jnp.asarray(p), jnp.asarray(x))))
    np.testing.assert_array_equal(
        got, np.asarray(bitmap_join_many_kernel(
            jnp.asarray(p), jnp.asarray(x), interpret=True)))


def test_bitmap_join_many_wrapper_masks_like_reference():
    p, x = words((2, 8)), words((2, 5, 8))
    mask = np.array([[1, 1, 1, 0, 0], [1, 0, 0, 0, 0]], bool)
    got = bj.bitmap_join_many(t32(p), t32(x), torch.from_numpy(mask))
    want = r_join_ops(jnp.asarray(p), jnp.asarray(x), jnp.asarray(mask),
                      mode="ref")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@settings(max_examples=10, deadline=None, database=None)
@given(st.integers(1, 5), st.integers(1, 20), st.integers(1, 70))
def test_property_bitmap_join_many_plain(b, e, w):
    p, x = words((b, w)), words((b, e, w))
    np.testing.assert_array_equal(
        bitmap_join_many_ref(t32(p), t32(x)).numpy(),
        np.asarray(r_join_ref(jnp.asarray(p), jnp.asarray(x))))


# ----------------------------------------------------------- bitmap_join
@pytest.mark.parametrize("e,w", [(1, 1), (7, 33), (256, 512), (300, 700),
                                 (513, 1025)])
def test_bitmap_join_plain_and_wrapper_match_reference_kernel(e, w):
    """The reference's kernel test shapes; the first words of the prefix
    and of the last extension row are bit-31 and edge patterns."""
    p, x = words(w), words((e, w))
    p[:min(w, len(SPECIAL))] = SPECIAL[:w]
    x[-1, :min(w, len(SPECIAL))] = SPECIAL[::-1][:w]
    want = np.asarray(bitmap_join_kernel(jnp.asarray(p), jnp.asarray(x),
                                         interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(r_single_ref(jnp.asarray(p), jnp.asarray(x))))
    n0 = bj.single_launches
    for got in (bitmap_join_ref(t32(p), t32(x)),
                bj.bitmap_join(t32(p), t32(x))):
        assert got.dtype == torch.int32 and got.shape == (e,)
        np.testing.assert_array_equal(got.numpy(), want)
    assert bj.single_launches == n0


def test_bitmap_join_all_bit31_words_and_empty_shapes():
    ones = np.full((3, 40), 0xFFFFFFFF, np.uint32)
    got = bj.bitmap_join(t32(ones[0]), t32(ones))
    np.testing.assert_array_equal(got.numpy(), [40 * 32] * 3)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(r_single_ops(jnp.asarray(ones[0]),
                                             jnp.asarray(ones))))
    n0 = bj.single_launches
    empty_e = bj.bitmap_join(t32(words(5)), t32(words((0, 5))))
    empty_w = bj.bitmap_join(t32(words(0)), t32(words((4, 0))))
    assert empty_e.shape == (0,) and empty_w.tolist() == [0] * 4
    assert empty_w.dtype == torch.int32
    assert bj.single_launches == n0


@settings(max_examples=10, deadline=None, database=None)
@given(st.integers(1, 64), st.integers(1, 96))
def test_property_bitmap_join_plain(e, w):
    p, x = words(w), words((e, w))
    np.testing.assert_array_equal(
        bitmap_join_ref(t32(p), t32(x)).numpy(),
        np.asarray(r_single_ref(jnp.asarray(p), jnp.asarray(x))))


def test_bitmap_join_wrapper_rejects_bad_inputs():
    p, x = t32(words(4)), t32(words((3, 4)))
    with pytest.raises(TypeError):
        bj.bitmap_join(p.long(), x)
    with pytest.raises(ValueError):
        bj.bitmap_join(p[:3], x)
    with pytest.raises(ValueError):
        bj.bitmap_join(p, x[None])
    with pytest.raises(ValueError, match="different devices"):
        bj.bitmap_join(p.to("meta"), x)


# ------------------------------------------------- gather_intersect_many
@pytest.mark.parametrize("b,s,e,w", [(1, 7, 1, 2), (3, 16, 4, 3),
                                     (5, 33, 2, 8), (2, 64, 6, 4),
                                     (4, 64, 1, 40)])
def test_gather_intersect_many_plain_matches_reference(b, s, e, w):
    tids = tids_batch(b, s, w, empty_rows=(b - 1,) if b > 1 else ())
    x = words((b, e, w))
    got = gather_intersect_many_ref(torch.from_numpy(tids), t32(x)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, gather_intersect_many_np(tids, x))
    np.testing.assert_array_equal(
        got, np.asarray(r_gather_ref(jnp.asarray(tids), jnp.asarray(x))))
    np.testing.assert_array_equal(
        got, np.asarray(gather_intersect_many_kernel(
            jnp.asarray(tids), jnp.asarray(x), interpret=True)))


def test_gather_intersect_all_padding_and_empty_tid_axis():
    x = np.full((2, 2, 2), 0xFFFFFFFF, np.uint32)
    tids = np.full((2, 9), -1, np.int32)
    tids[0, :3] = [1, 40, 63]
    got = gi.gather_intersect_many(torch.from_numpy(tids), t32(x))
    np.testing.assert_array_equal(got.numpy(), [[3, 3], [0, 0]])
    empty = torch.zeros((2, 0), dtype=torch.int32)
    got = gi.gather_intersect_many(empty, t32(words((2, 3, 4))))
    want = r_gather_ops(jnp.zeros((2, 0), jnp.int32),
                        jnp.asarray(words((2, 3, 4))), mode="ref")
    assert got.shape == (2, 3) and not got.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_intersect_wrapper_masks_like_reference():
    tids = tids_batch(3, 20, 5)
    x = words((3, 4, 5))
    mask = RNG.random((3, 4)) < 0.5
    got = gi.gather_intersect_many(torch.from_numpy(tids), t32(x),
                                   torch.from_numpy(mask))
    want = r_gather_ops(jnp.asarray(tids), jnp.asarray(x),
                        jnp.asarray(mask), mode="pallas-interpret")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------ indexed entries
# (n_rows, stride, n_words, B, E): few rows (handles repeat across and
# inside requests), n_words below the stride, a store of odd width 3,125
# (rows off the 16-byte grid), the mirror's pow2 stride over 3,125 words
@pytest.mark.parametrize("n_rows,stride,n_words,b,e", [
    (6, 8, 8, 3, 5), (20, 64, 33, 4, 9), (9, 3125, 3125, 2, 3),
    (12, 4096, 3125, 3, 4)])
def test_bitmap_join_many_rows_plain_matches_reference_kernel(
        n_rows, stride, n_words, b, e):
    rng = np.random.default_rng(n_rows * 1000 + n_words)
    m, pidx, eidx = cases.dense_case(rng, n_rows, stride, b, e)
    p = cases.gathered_rows(m, pidx, n_words)
    x = cases.gathered_rows(m, eidx, n_words)
    want = np.asarray(bitmap_join_many_kernel(jnp.asarray(p), jnp.asarray(x),
                                              interpret=True))
    args = (t32(m), torch.from_numpy(pidx), t32(m), torch.from_numpy(eidx),
            n_words)
    n0 = bj.launches
    for got in (bitmap_join_many_rows_ref(*args),
                bj.bitmap_join_many_rows(*args)):
        assert got.dtype == torch.int32 and got.shape == (b, e)
        np.testing.assert_array_equal(got.numpy(), want)
    assert bj.launches == n0
    assert not want[eidx < 0].any() and not want[pidx < 0].any()


# (n_rows, stride, n_words, B, E, L): prefix tuples of L rows (mixed
# lengths in one batch, a pad request), over a segment-width store of
# odd stride and one of 79 words, and over pow2 mirror strides
@pytest.mark.parametrize("n_rows,stride,n_words,b,e,tuple_len", [
    (6, 8, 8, 3, 5, 2), (20, 64, 33, 4, 9, 3), (30, 79, 79, 5, 7, 8),
    (16, 333, 333, 4, 70, 3), (12, 128, 79, 3, 4, 2)])
def test_bitmap_join_many_rows_tuples_match_and_then_join(
        n_rows, stride, n_words, b, e, tuple_len):
    """The [B, L] plain version equals an explicit AND of each tuple
    followed by the reference kernel's join of that prefix."""
    rng = np.random.default_rng(n_rows * 100 + stride + tuple_len)
    m, pidx, eidx = cases.tuple_case(rng, n_rows, stride, b, e, tuple_len)
    p = cases.gathered_tuple_prefixes(m, pidx, n_words)
    x = cases.gathered_rows(m, eidx, n_words)
    want = np.asarray(bitmap_join_many_kernel(jnp.asarray(p), jnp.asarray(x),
                                              interpret=True))
    args = (t32(m), torch.from_numpy(pidx), t32(m), torch.from_numpy(eidx),
            n_words)
    n0 = bj.launches
    for got in (bitmap_join_many_rows_ref(*args),
                bj.bitmap_join_many_rows(*args)):
        assert got.dtype == torch.int32 and got.shape == (b, e)
        np.testing.assert_array_equal(got.numpy(), want)
    assert bj.launches == n0
    assert not want[-1].any()                   # the pad request
    # L = 1 as [B, 1] is the [B] form
    one = torch.from_numpy(np.ascontiguousarray(pidx[:, :1]))
    np.testing.assert_array_equal(
        bj.bitmap_join_many_rows(t32(m), one, t32(m),
                                 torch.from_numpy(eidx), n_words).numpy(),
        bj.bitmap_join_many_rows(t32(m), one[:, 0].contiguous(), t32(m),
                                 torch.from_numpy(eidx), n_words).numpy())
    with pytest.raises(ValueError, match="L >= 1"):
        bj.bitmap_join_many_rows(t32(m), one[:, :0], t32(m),
                                 torch.from_numpy(eidx), n_words)


# (n_rows, stride, n_words, B, E, S, tids past n_words): as above, plus
# a store read at a narrower width with tids past it (clamped to the
# last word read, which the reference's jnp and numpy oracles do too)
@pytest.mark.parametrize("n_rows,stride,n_words,b,e,s,past", [
    (6, 8, 8, 3, 5, 40, False), (20, 64, 33, 4, 9, 70, False),
    (9, 3125, 3125, 3, 3, 300, False), (12, 4096, 3125, 4, 4, 300, False),
    (20, 64, 33, 4, 9, 70, True)])
def test_gather_intersect_many_rows_plain_matches_reference_kernel(
        n_rows, stride, n_words, b, e, s, past):
    rng = np.random.default_rng(n_rows * 1000 + n_words + s)
    m, tids, lens, eidx = cases.sparse_case(rng, n_rows, stride, n_words,
                                            b, e, s, past_width=past)
    t = cases.gathered_tids(tids, lens)
    x = cases.gathered_rows(m, eidx, n_words)
    want = gather_intersect_many_np(t, x)
    np.testing.assert_array_equal(
        want, np.asarray(r_gather_ref(jnp.asarray(t), jnp.asarray(x))))
    if not past:
        np.testing.assert_array_equal(want, np.asarray(
            gather_intersect_many_kernel(jnp.asarray(t), jnp.asarray(x),
                                         interpret=True)))
    args = (torch.from_numpy(tids), torch.from_numpy(lens), t32(m),
            torch.from_numpy(eidx), n_words)
    n0 = gi.launches
    for got in (gather_intersect_many_rows_ref(*args),
                gi.gather_intersect_many_rows(*args)):
        assert got.dtype == torch.int32 and got.shape == (b, e)
        np.testing.assert_array_equal(got.numpy(), want)
    assert gi.launches == n0
    assert not want[eidx < 0].any()


def test_indexed_entries_empty_and_bad_inputs():
    m = t32(words((4, 8)))
    pidx = torch.tensor([0, 1], dtype=torch.int32)
    eidx = torch.tensor([[1, 2], [3, -1]], dtype=torch.int32)
    tids = torch.tensor([[1, 2, -1], [5, 9, 40]], dtype=torch.int32)
    lens = torch.tensor([2, 3], dtype=torch.int32)
    assert not bj.bitmap_join_many_rows(m, pidx, m, eidx, 0).any()
    assert not gi.gather_intersect_many_rows(tids, lens, m, eidx, 0).any()
    assert gi.gather_intersect_many_rows(
        tids[:, :0], lens, m, eidx, 8).shape == (2, 2)
    with pytest.raises(TypeError):
        bj.bitmap_join_many_rows(m, pidx.long(), m, eidx, 8)
    with pytest.raises(TypeError):
        gi.gather_intersect_many_rows(tids, lens, m.long(), eidx, 8)
    with pytest.raises(ValueError, match="row width"):
        bj.bitmap_join_many_rows(m, pidx, m, eidx, 9)
    with pytest.raises(ValueError, match="word stride"):
        bj.bitmap_join_many_rows(m, pidx, m.t(), eidx, 2)
    with pytest.raises(ValueError, match="batch"):
        bj.bitmap_join_many_rows(m, pidx[:1], m, eidx, 8)
    with pytest.raises(ValueError, match="batch"):
        gi.gather_intersect_many_rows(tids, lens[:1], m, eidx, 8)
    with pytest.raises(ValueError, match="different devices"):
        bj.bitmap_join_many_rows(m, pidx, m.to("meta"), eidx, 8)


# ----------------------------------------------------------- device rule
def test_cpu_tensors_run_the_plain_version_without_launching():
    b0, g0 = bj.launches, gi.launches
    bj.bitmap_join_many(t32(words((2, 4))), t32(words((2, 3, 4))))
    gi.gather_intersect_many(torch.from_numpy(tids_batch(2, 8, 4)),
                             t32(words((2, 3, 4))))
    m, idx = t32(words((4, 4))), torch.zeros((2, 3), dtype=torch.int32)
    bj.bitmap_join_many_rows(m, idx[:, 0], m, idx, 4)
    gi.gather_intersect_many_rows(idx, idx[:, 0], m, idx, 4)
    assert (bj.launches, gi.launches) == (b0, g0)


def test_wrappers_reject_bad_inputs():
    p, x = t32(words((2, 4))), t32(words((2, 3, 4)))
    with pytest.raises(TypeError):
        bj.bitmap_join_many(p.long(), x)
    with pytest.raises(ValueError):
        bj.bitmap_join_many(p[:1], x)
    with pytest.raises(TypeError):
        gi.gather_intersect_many(torch.zeros((2, 3)), x)
    with pytest.raises(ValueError):
        gi.gather_intersect_many(torch.zeros((3, 3), dtype=torch.int32), x)
