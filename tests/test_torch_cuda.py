"""The CUDA kernels on the card: each held exactly against its plain
version, the wrappers' no-fallback rule, and small mines through the
batched kernels at every granularity that reaches them. Every test here
is marked ``cuda`` and skips on a host without a CUDA device; run them
on the card with
``python -m pytest -m cuda tests/test_torch_cuda.py``. This file imports
no JAX, so it also collects where JAX is not installed."""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.tidlist import pack_database, to_device_words
from repro_torch.kernels.bitmap_join import ops as bj
from repro_torch.kernels.bitmap_join.ref import (bitmap_join_many_ref,
                                                 bitmap_join_ref)
from repro_torch.kernels.gather_intersect import ops as gi
from repro_torch.kernels.gather_intersect.ref import (
    gather_intersect_many_ref)

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
