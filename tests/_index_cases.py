"""Seeded inputs of the kernels' indexed entries, shared by the CPU
parity tests and the card tests (numpy only; no JAX, no torch).

A case is a uint32 row store (the shape of the arena's device mirror:
``n_rows`` rows ``stride`` words apart, of which a sweep reads
``n_words``) with int32 row indices into it, and its gathered
equivalent: the [B, W] / [B, E, W] arrays the reference's kernels take,
with pad requests and pad lanes as zero rows (they count 0) and tids
past a request's length as -1."""
import numpy as np

SPECIAL = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x55555555,
                    0xAAAAAAAA, 0x0F0F0F0F, 0xF0F0F0F0, 0x80000001],
                   np.uint32)


def store(rng, n_rows, stride):
    """[n_rows, stride] random words; row 0 starts with bit-31 and other
    edge patterns."""
    m = rng.integers(0, 2 ** 32, size=(n_rows, stride), dtype=np.uint32)
    m[0, :min(stride, len(SPECIAL))] = SPECIAL[:stride]
    return m


def ext_index(rng, n_rows, b, e):
    """[b, e] row indices: ragged requests (lanes past a random count
    are -1), a handle repeated inside request 0, row 0 named."""
    eidx = rng.integers(0, n_rows, size=(b, e)).astype(np.int32)
    eidx[0, 0] = 0
    if e > 1:
        eidx[0, 1] = eidx[0, 0]
    for i in range(1, b):
        eidx[i, int(rng.integers(1, e + 1)):] = -1
    return eidx


def dense_case(rng, n_rows, stride, b, e):
    """(store, pidx [b], eidx [b, e]): request 0's prefix is also one of
    its extension rows, and the last request (b > 1) is a pad request."""
    pidx = rng.integers(0, n_rows, size=b).astype(np.int32)
    eidx = ext_index(rng, n_rows, b, e)
    pidx[0] = eidx[0, 0]
    if b > 1:
        pidx[-1] = -1
    return store(rng, n_rows, stride), pidx, eidx


def sparse_case(rng, n_rows, stride, n_words, b, e, s, past_width=False):
    """(store, tids [b, s], lens [b], eidx [b, e]). Request 0 holds tids
    on bit 31 and is shorter than s (-1 after them); request 1 is a full
    random row; from request 2 on ``lens`` stops before the row's valid
    tids end, and the tids past it must not count. ``past_width`` draws
    tids up to the store's row width, past the first ``n_words`` words."""
    hi = 32 * (stride if past_width else n_words)
    tids = np.full((b, s), -1, np.int32)
    lens = np.zeros(b, np.int32)
    for i in range(b):
        if i == 0:
            t = np.arange(min(s - 1, n_words)) * 32 + 31
        else:
            n = min(s, hi) if i == 1 else int(rng.integers(1, min(s, hi) + 1))
            t = np.sort(rng.choice(hi, size=n, replace=False))
        tids[i, :len(t)] = t
        lens[i] = s if i == 0 else len(t) if i == 1 else rng.integers(
            0, len(t))
    return store(rng, n_rows, stride), tids, lens, ext_index(rng, n_rows,
                                                               b, e)


def gathered_rows(m, idx, n_words):
    """``m[idx, :n_words]`` with -1 indices as zero rows."""
    return m[np.maximum(idx, 0), :n_words] * (idx >= 0)[..., None].astype(
        np.uint32)


def gathered_tids(tids, lens):
    """``tids`` with the slots at or past each request's length as -1."""
    past = np.arange(tids.shape[1])[None, :] >= lens[:, None]
    return np.where(past, -1, tids).astype(np.int32)


def tuple_case(rng, n_rows, stride, b, e, tuple_len):
    """(store, pidx [b, tuple_len], eidx [b, e]): prefix tuples of mixed
    lengths in one batch — request 0 full length, request 1 (b > 2) one
    row, the others a random length — with -1 past each tuple's end, and
    the last request (b > 1) a pad request (-1 at j = 0)."""
    pidx = rng.integers(0, n_rows, size=(b, tuple_len)).astype(np.int32)
    for i in range(1, b):
        n = 1 if i == 1 and b > 2 else int(rng.integers(1, tuple_len + 1))
        pidx[i, n:] = -1
    if b > 1:
        pidx[-1] = -1
    return store(rng, n_rows, stride), pidx, ext_index(rng, n_rows, b, e)


def gathered_tuple_prefixes(m, pidx, n_words):
    """[b, n_words]: the AND of each request's tuple rows (up to its
    first -1), zero for a pad request."""
    out = np.zeros((pidx.shape[0], n_words), np.uint32)
    for i, row in enumerate(pidx):
        if row[0] < 0:
            continue
        p = m[row[0], :n_words].copy()
        for h in row[1:]:
            if h < 0:
                break
            p &= m[h, :n_words]
        out[i] = p
    return out
