"""The least bytes each batched kernel launch must move, and the peak.

A traced run wraps the kernel backend's flush entry
(``TorchBackend.sweep_many``) and keeps, per flush, the rows each sweep
request names, so the count is the same whichever kernel serves a
request and never comes from a launch's padded shape. The backend
launches once per (flush, transaction segment, representation): the
dense requests of a segment go to ``bitmap_join_many`` and the sparse
ones (tid-list or diffset prefixes) to ``gather_intersect_many``.

What a launch must move, each byte read or written once:

- dense: every distinct row its requests name (prefix rows and
  extension rows of one store), ``W_seg`` 32-bit words each, plus one
  index per prefix row and per extension, plus one count per extension;
- sparse: each request's prefix payload inside the segment's tid window
  (one 32-bit tid each) and its length, plus every distinct 32-byte
  sector of an extension row that a payload tid falls in, plus one
  index and one count per extension.

The least time is those bytes at the card's HBM bandwidth; both kernels
do a handful of integer operations per word, far under the card's
integer rate, so bandwidth bounds them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# Published HBM bandwidth (bytes/s) by the device name's model, from
# NVIDIA's data sheets (H100 SXM5: 3.35 TB/s).
HBM_BYTES_PER_S = {"H100": 3.35e12}

WORD_BYTES = 4
SECTOR_BYTES = 32
KERNELS = ("bitmap_join_many", "gather_intersect_many")


def hbm_bytes_per_s(device_name: str) -> Optional[float]:
    for model, rate in HBM_BYTES_PER_S.items():
        if model in device_name:
            return rate
    return None


class RequestLog:
    """Wraps ``TorchBackend.sweep_many`` while open and keeps, per
    launch, what its requests name: ``(kernel, W_seg, rows)`` where
    ``rows`` is a list of (prefix handles, extension handles, payload)
    with ``payload`` the sparse prefix's tids rebased to the segment
    (None for a dense request)."""

    def __init__(self):
        self.launches: List[Tuple[str, int, list]] = []
        self._cls = None
        self._orig = None

    def __enter__(self) -> "RequestLog":
        from repro_torch.core import join_backend
        self._cls = join_backend.TorchBackend
        self._orig = orig = self._cls.sweep_many
        log = self

        def sweep_many(backend, arena, requests):
            log.record(arena, requests)
            return orig(backend, arena, requests)

        self._cls.sweep_many = sweep_many
        return self

    def __exit__(self, *exc) -> None:
        self._cls.sweep_many = self._orig

    def record(self, arena, requests) -> None:
        by: Dict[Tuple[int, bool], list] = {}
        for r in requests:
            sparse = r.is_sparse(arena)
            tids = arena.tids_of(r.prefix_handle) if sparse else None
            for g in r.segment_ids(arena):
                w = arena.seg_words(g)
                if not w:
                    continue
                payload = None
                if sparse:
                    lo, hi = arena.seg_tid_range(g)
                    i0, i1 = np.searchsorted(tids, [lo, hi])
                    payload = np.asarray(tids[i0:i1], np.int64) - lo
                by.setdefault((g, sparse), []).append(
                    (r.prefix_handles, r.ext_handles, payload))
        for (g, sparse), rows in sorted(by.items()):
            self.launches.append((KERNELS[sparse], arena.seg_words(g), rows))

    def bytes_by_kernel(self) -> Dict[str, int]:
        out = {k: 0 for k in KERNELS}
        for kernel, w, rows in self.launches:
            out[kernel] += (dense_bytes(w, rows) if kernel == KERNELS[0]
                            else sparse_bytes(rows))
        return out


def dense_bytes(w: int, rows: list) -> int:
    names = set()
    lanes = 0
    for prefix, exts, _ in rows:
        names.update(prefix)
        names.update(exts)
        lanes += len(prefix) + 2 * len(exts)
    return (len(names) * w + lanes) * WORD_BYTES


def sparse_bytes(rows: list) -> int:
    sectors_of: Dict[int, List[np.ndarray]] = {}
    words = 0
    for _, exts, payload in rows:
        # tid t sits in word t >> 5, and that word in sector word >> 3
        sec = np.unique(payload >> 8)
        for e in exts:
            sectors_of.setdefault(e, []).append(sec)
        words += len(payload) + 1 + 2 * len(exts)
    sectors = 0
    for parts in sectors_of.values():
        sectors += (len(parts[0]) if len(parts) == 1
                    else len(np.unique(np.concatenate(parts))))
    return sectors * SECTOR_BYTES + words * WORD_BYTES
