"""Transaction-ID (TID) bitmap machinery.

The paper's per-task computation is a TID-list join: support(itemset) =
|∩_{i∈itemset} tidlist(i)|. TID lists are packed uint32 bitmaps on the
host (numpy, GIL-released) and the join is AND + popcount. On the card
the same words live in an int32 tensor, the bit-identical view of the
uint32 words (:func:`to_device_words`): this PyTorch build has no
popcount, and its uint32 tensors lack ``>>``, so the kernels and their
plain versions work on int32 and read the words as unsigned.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

WORD = 32


def n_words(n_transactions: int) -> int:
    return (n_transactions + WORD - 1) // WORD


def pow2(n: int, lo: int = 1) -> int:
    """Smallest power of two times ``lo`` that is >= ``n``."""
    p = lo
    while p < n:
        p *= 2
    return p


def resolve_device(device: "torch.device | str | None") -> torch.device:
    """``None`` means the CUDA card. Asking for CUDA on a host without
    one raises at once: the CPU runs only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the host")
    return dev


def to_device_words(bitmaps: np.ndarray,
                    device: "torch.device | str") -> torch.Tensor:
    """[..., W] uint32 bitmaps -> the same words as an int32 tensor on
    ``device``, bit for bit (a word with bit 31 set reads negative)."""
    words = np.ascontiguousarray(bitmaps, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(words).to(device)


def from_device_words(words: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`to_device_words`: int32 tensor -> uint32 array."""
    if words.dtype != torch.int32:
        raise TypeError(f"expected an int32 tensor, got {words.dtype}")
    return words.detach().cpu().contiguous().numpy().view(np.uint32)


def pack_database(db: Sequence[Sequence[int]], n_items: int,
                  return_counts: bool = False):
    """db: list of transactions (item id lists) -> [n_items, W] uint32.

    Packs per-word directly — O(n_items × W) memory, never the dense
    [n_items, n_transactions] bool matrix.

    With ``return_counts=True`` also returns the per-item ones count
    (``[n_items] int64``) tallied during the same pass — the level-1
    supports and density seed, with no post-hoc popcount sweep over
    the packed words."""
    m = len(db)
    out = np.zeros((n_items, n_words(m)), dtype=np.uint32)
    counts = np.zeros(n_items, dtype=np.int64)
    for t, txn in enumerate(db):
        word = t >> 5
        bit = np.uint32(1 << (t & 31))
        for i in txn:
            if not out[i, word] & bit:
                counts[i] += 1
            out[i, word] |= bit
    if return_counts:
        return out, counts
    return out


def pack_bool(bits: np.ndarray) -> np.ndarray:
    """[I, T] bool -> [I, W] uint32 (little-endian bit order per word)."""
    i, t = bits.shape
    w = n_words(t)
    padded = np.zeros((i, w * WORD), dtype=bool)
    padded[:, :t] = bits
    packed = np.packbits(padded.reshape(i, w, WORD)[:, :, ::-1], axis=-1)
    return packed.view(">u4").astype(np.uint32).reshape(i, w)


def unpack_bool(packed: np.ndarray, n_transactions: int) -> np.ndarray:
    """[I, W] uint32 -> [I, T] bool."""
    i, w = packed.shape
    be = packed.astype(">u4")
    by = be.view(np.uint8).reshape(i, w, 4)
    bits = np.unpackbits(by, axis=-1).reshape(i, w * WORD).astype(bool)
    # restore per-word little-endian bit order
    bits = bits.reshape(i, w, WORD)[:, :, ::-1].reshape(i, w * WORD)
    return bits[:, :n_transactions]


def popcount32(x: np.ndarray) -> np.ndarray:
    """Vectorized popcount for uint32 arrays (numpy, GIL-released)."""
    if hasattr(np, "bitwise_count"):          # numpy >= 2.0: one ufunc pass
        return np.bitwise_count(x).astype(np.int64)
    if x.dtype != np.uint32:
        x = x.astype(np.uint32)
    x = x - ((x >> 1) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> 2) & np.uint32(0x33333333))
    x = (x + (x >> 4)) & np.uint32(0x0F0F0F0F)
    return ((x * np.uint32(0x01010101)) >> 24).astype(np.int64)


def intersect(bitmaps: np.ndarray) -> np.ndarray:
    """AND-reduce [k, W] -> [W]."""
    out = bitmaps[0].copy()
    for b in bitmaps[1:]:
        out &= b
    return out


def support_of(bitmap_rows: np.ndarray) -> int:
    """|∩ rows| for a [k, W] stack of bitmaps."""
    return int(popcount32(intersect(bitmap_rows)).sum())


# Target working-set size for one [chunk, W] AND+popcount temporary:
# roughly half an L2 slice, so the chunk stays cache-resident even on
# scaled datasets where W grows with the transaction count.
CHUNK_TARGET_BYTES = 4 << 20


def support_counts(prefix: np.ndarray, exts: np.ndarray,
                   chunk: int | None = None) -> np.ndarray:
    """counts[e] = |prefix ∩ exts[e]|. prefix: [W]; exts: [E, W].

    The numpy bucket sweep: one fused AND+popcount pass with the prefix
    row broadcast across all extensions. ``chunk`` bounds the [chunk, W]
    temporary; by default it adapts to W so the temporary stays
    ~CHUNK_TARGET_BYTES regardless of dataset scale."""
    e, w = exts.shape
    if e == 1:
        return popcount32(exts[0] & prefix).sum(keepdims=True)
    if chunk is None:
        chunk = max(64, CHUNK_TARGET_BYTES // max(w * (WORD // 8), 1))
    if e <= chunk:
        return popcount32(exts & prefix[None, :]).sum(axis=1)
    out = np.empty(e, dtype=np.int64)
    for lo in range(0, e, chunk):
        hi = min(lo + chunk, e)
        out[lo:hi] = popcount32(exts[lo:hi] & prefix[None, :]).sum(axis=1)
    return out


# ---------------------------------------------------------------------------
# Sparse (tid-list / dEclat diffset) row helpers
# ---------------------------------------------------------------------------
# A *tid* is a bit position on the word axis: tid = 32 * word + bit.

REP_BITMAP, REP_TIDLIST, REP_DIFFSET = 0, 1, 2
REP_NAMES = ("bitmap", "tidlist", "diffset")


def bitmap_to_tids(words: np.ndarray) -> np.ndarray:
    """[W] uint32 word-column -> sorted uint32 tids of its set bits."""
    w = words.shape[0]
    if w == 0:
        return np.zeros(0, np.uint32)
    bits = unpack_bool(words[None, :], w * WORD)[0]
    return np.flatnonzero(bits).astype(np.uint32)


def tids_to_bitmap(tids: np.ndarray, n_words_: int) -> np.ndarray:
    """Sorted uint32 tids -> [n_words_] uint32 word-column."""
    out = np.zeros(n_words_, np.uint32)
    if len(tids):
        t = np.asarray(tids, np.uint32)
        np.bitwise_or.at(out, t >> np.uint32(5),
                         np.uint32(1) << (t & np.uint32(31)))
    return out


def gather_bits(tids: np.ndarray, ext_words: np.ndarray) -> np.ndarray:
    """Bit test of ``ext_words`` at each tid -> [len(tids)] bool: the
    sparse sweep primitive, O(|tids|) words whatever the row width."""
    if len(tids) == 0:
        return np.zeros(0, bool)
    t = np.asarray(tids, np.uint32)
    return ((ext_words[t >> np.uint32(5)] >> (t & np.uint32(31)))
            & np.uint32(1)).astype(bool)


def gather_count(tids: np.ndarray, ext_words: np.ndarray) -> int:
    """|tids ∩ ext| for one sparse row against one word-column."""
    if len(tids) == 0:
        return 0
    t = np.asarray(tids, np.uint32)
    return int((((ext_words[t >> np.uint32(5)] >> (t & np.uint32(31)))
                 & np.uint32(1))).sum())


def sorted_difference(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a \\ b for sorted unique uint32 arrays (diffset reconstruction:
    tids(P) = tids(parent) \\ diffset), by binary search."""
    if len(b) == 0 or len(a) == 0:
        return a
    idx = np.searchsorted(b, a)
    np.minimum(idx, len(b) - 1, out=idx)
    return a[b[idx] != a]


# ---------------------------------------------------------------------------
# BitmapArena: the home of every TID bitmap, with a device mirror
# ---------------------------------------------------------------------------

# Device residency of an arena's rows (``BitmapArena(backing=)``). The
# names are the reference engine's, so its calls port unchanged; "jax"
# means an eager upload to the arena's torch device.
ARENA_BACKINGS = ("auto", "numpy", "jax")


class BitmapArena:
    """Append-only ``[N, W]`` uint32 row store with integer handles.

    Every bitmap the mining engine touches lives here: the pinned item
    bitmaps loaded once by :meth:`from_bitmaps` (handle == item id), the
    cached prefix intersections and the depth-first engine's child
    handoff rows. Tasks pass *handles* around, so the sweep dispatcher
    can batch many workers' requests into one kernel launch without
    re-marshalling bitmap payloads.

    Rows are refcounted: :meth:`push` returns a handle with refcount 1,
    :meth:`retain`/:meth:`release` adjust it, and a row whose count
    reaches zero goes on a free list — the next push reuses the slot.
    Rows below ``n_base`` (the item bitmaps) are pinned.

    Sparse rows (tid-lists and dEclat diffsets) share the handle space,
    refcounting and accounting with word-column rows but carry their
    payload as a uint32 tid array; their word-column slot is dead and the
    device mirror keeps it zeroed.

    The device mirror (:meth:`device_rows`) is one int32 tensor on
    ``device``, kept in sync incrementally: only rows appended or
    recycled since the last sync cross host→device, and their payload
    bytes accumulate in ``h2d_bytes``. Host-only backends never call it.
    ``device=None`` means the CUDA card and raises ``RuntimeError`` when
    there is none; the mirror lives on the CPU only when the caller
    passes ``"cpu"``.

    Device residency (``backing``, one of ``ARENA_BACKINGS``):
      "auto"   the mirror is created lazily by the first
               :meth:`device_rows` call;
      "jax"    the same mirror, with the base rows uploaded eagerly at
               load (the reference engine's name for it; here it means
               an eager upload to ``device``);
      "numpy"  host-only: no mirror, :meth:`device_rows` returns None
               and the kernel backend gathers each batch's rows on the
               host and uploads them per launch (the transfer-bound
               baseline).

    ``tracer`` is None (tracing off) unless an engine attaches one; a
    mirror sync that moves payload then records an ``h2d-sync`` span,
    and :meth:`count_h2d` an ``h2d`` instant, on the calling lane.

    The arena holds one shard and one segment. The row-creating calls
    take the reference's ``shard=`` and ``cover=`` arguments so the
    engines call both arenas alike, and accept only the single-segment
    values (``shard=0``, ``cover`` None or 1).

    Thread-safe: workers push/release concurrently; the mirror is touched
    only by the dispatcher thread. Growth reallocates the host store, but
    handed-out row views keep the old buffer alive and live rows are
    never mutated, so views stay content-correct.
    """

    GROW = 2                      # capacity doubling factor

    def __init__(self, n_words_: int,
                 device: "torch.device | str | None" = None,
                 capacity: int = 64, backing: str = "auto"):
        if backing not in ARENA_BACKINGS:
            raise ValueError(
                f"arena backing must be one of {ARENA_BACKINGS}, "
                f"got {backing!r}")
        self.device = resolve_device(device)
        self.backing = backing
        # observability: None = off (the engines attach a tracer)
        self.tracer = None
        cap = max(capacity, 1)
        self._n_words = n_words_
        self._store = np.zeros((cap, n_words_), np.uint32)
        self._refs = np.zeros(cap, np.int32)
        self._rep = np.zeros(cap, np.int8)        # REP_* tag per slot
        self.n_rows = 0               # high-water mark (rows ever used)
        self.n_base = 0               # pinned item rows [0, n_base)
        self._free: list = []
        self._lock = threading.Lock()
        # live-row gauges (rows beyond the pinned base — the engine's
        # retained-bitmap memory bound)
        self.live_extra = 0
        self.peak_live_extra = 0
        # device mirror: rows [0, _dev_n) have been placed; _stale holds
        # recycled slots below _dev_n whose mirror content is out of date
        self._mirror: Optional[torch.Tensor] = None
        self._dev_n = 0
        self._stale: set = set()
        self.h2d_bytes = 0            # bitmap payload uploaded, total
        self._sparse: dict = {}                   # handle -> uint32 tids
        self._anchor: dict = {}                   # diffset -> parent handle
        self._ssupport: dict = {}                 # handle -> support
        self.sparse_pushed = 0        # sparse rows ever created
        self.sparse_live = 0          # live sparse rows gauge
        self.sparse_bytes_live = 0    # live sparse payload bytes
        self.peak_sparse_bytes = 0
        self.densify_ops = 0          # sparse->dense conversions billed
        self.densify_bytes = 0
        self.sparsify_ops = 0         # dense->sparse conversions billed
        self.sparsify_bytes = 0

    @property
    def n_words(self) -> int:
        return self._n_words

    @property
    def mirror_words(self) -> int:
        """Row width of the device mirror: ``n_words`` zero-padded to a
        power of two. Pad words AND to zero and count nothing, and the
        kernels read only ``n_words`` of each row; the pad keeps every
        row 16-byte aligned for their 128-bit loads."""
        return pow2(self._n_words)

    # ------------------------------------------------------------- load --
    @classmethod
    def from_bitmaps(cls, bitmaps: np.ndarray,
                     device: "torch.device | str | None" = None,
                     backing: str = "auto") -> "BitmapArena":
        """Load packed item bitmaps as the pinned base rows (handle ==
        item id). One copy, once; ``backing="jax"`` also uploads them to
        the mirror now."""
        n, w = bitmaps.shape
        arena = cls(w, device, capacity=max(64, 2 * n), backing=backing)
        arena._store[:n] = bitmaps
        arena._refs[:n] = 1
        arena.n_rows = arena.n_base = n
        if backing == "jax":
            arena.device_rows()
        return arena

    @classmethod
    def from_database(cls, db: Sequence[Sequence[int]], n_items: int,
                      device: "torch.device | str | None" = None,
                      backing: str = "auto") -> "BitmapArena":
        """pack_database straight into the arena (no intermediate)."""
        return cls.from_bitmaps(pack_database(db, n_items), device,
                                backing)

    # ------------------------------------------------------ row lifecycle --
    def _alloc_slot(self) -> int:
        # caller holds self._lock
        if self._free:
            slot = self._free.pop()
            if slot < self._dev_n:
                self._stale.add(slot)     # mirror content now out of date
            return slot
        if self.n_rows == self._refs.shape[0]:
            cap = self.GROW * self._refs.shape[0]
            store = np.zeros((cap, self._n_words), np.uint32)
            store[:self.n_rows] = self._store[:self.n_rows]
            refs = np.zeros(cap, np.int32)
            refs[:self.n_rows] = self._refs[:self.n_rows]
            rep = np.zeros(cap, np.int8)
            rep[:self.n_rows] = self._rep[:self.n_rows]
            self._store, self._refs, self._rep = store, refs, rep
        slot = self.n_rows
        self.n_rows += 1
        return slot

    def _bump_live(self) -> None:
        self.live_extra += 1
        self.peak_live_extra = max(self.peak_live_extra, self.live_extra)

    @staticmethod
    def _one_segment(shard: int, cover: Optional[int]) -> None:
        if shard != 0 or cover not in (None, 1):
            raise ValueError(
                "this arena holds one shard and one segment; got "
                f"shard={shard}, cover={cover}")

    def push(self, row: np.ndarray, shard: int = 0,
             cover: Optional[int] = None) -> int:
        """Append (or recycle a slot for) one bitmap row; refcount 1."""
        self._one_segment(shard, cover)
        with self._lock:
            slot = self._alloc_slot()
            self._store[slot] = row
            self._refs[slot] = 1
            self._rep[slot] = REP_BITMAP
            self._bump_live()
            return slot

    def materialize(self, prefix_handle: int, ext_handle: int,
                    shard: int = 0) -> int:
        """``row(prefix) ∧ row(ext)`` written in place into a fresh slot
        — the depth-first parent→child handoff, with no floating
        temporary. The device mirror picks the row up at its next
        sync, billed like any pushed row."""
        self._one_segment(shard, None)
        with self._lock:
            slot = self._alloc_slot()
            store = self._store
            np.bitwise_and(store[prefix_handle], store[ext_handle],
                           out=store[slot])
            self._refs[slot] = 1
            self._rep[slot] = REP_BITMAP
            self._bump_live()
            return slot

    # ------------------------------------------------- sparse lifecycle --
    def _push_sparse(self, rep: int, tids: np.ndarray, support: int,
                     shard: int, cover: Optional[int],
                     anchor: Optional[int] = None) -> int:
        self._one_segment(shard, cover)
        t = np.ascontiguousarray(tids, dtype=np.uint32)
        with self._lock:
            slot = self._alloc_slot()
            self._refs[slot] = 1
            self._rep[slot] = rep
            self._sparse[slot] = t
            self._ssupport[slot] = int(support)
            if anchor is not None:
                self._anchor[slot] = anchor
                if anchor >= self.n_base:     # pin the diffset's parent
                    self._refs[anchor] += 1
            self.sparse_pushed += 1
            self.sparse_live += 1
            self.sparse_bytes_live += t.nbytes
            self.peak_sparse_bytes = max(self.peak_sparse_bytes,
                                         self.sparse_bytes_live)
            self._bump_live()
            return slot

    def push_tids(self, tids: np.ndarray, shard: int = 0,
                  cover: Optional[int] = None) -> int:
        """Append one sparse row as a sorted uint32 tid-list; refcount 1."""
        return self._push_sparse(REP_TIDLIST, tids, len(tids), shard,
                                 cover)

    def push_diffset(self, diff: np.ndarray, anchor: int, support: int,
                     shard: int = 0, cover: Optional[int] = None) -> int:
        """Append one dEclat diffset row: ``diff`` holds the tids of the
        *anchor* (parent prefix) row NOT in this row, so this row's tid
        set is ``tids(anchor) \\ diff`` and its support is ``support``.
        The anchor is retained until this row is released."""
        return self._push_sparse(REP_DIFFSET, diff, support, shard, cover,
                                 anchor=anchor)

    def sparsify_push(self, row: np.ndarray) -> int:
        """Scan a dense word-row into a tid-list row (billed sparsify
        conversion) — the prefix cache's path when the density model
        says a freshly built intersection should live sparse."""
        t = bitmap_to_tids(row)
        with self._lock:
            self.sparsify_ops += 1
            self.sparsify_bytes += row.nbytes
        return self.push_tids(t)

    def rep_of(self, handle: int) -> int:
        """REP_BITMAP / REP_TIDLIST / REP_DIFFSET tag of a row."""
        return int(self._rep[handle])

    def rep_name(self, handle: int) -> str:
        return REP_NAMES[self.rep_of(handle)]

    def cover_of(self, handle: int) -> int:
        """Segments a row covers: always the one segment here."""
        return 1

    def tids_of(self, handle: int) -> np.ndarray:
        """Raw sparse payload of a tid-list or diffset row (for a diffset
        this is the *difference*, not the tid set — see
        :meth:`resolve_tids`)."""
        return self._sparse[handle]

    def anchor_of(self, handle: int) -> Optional[int]:
        """The parent row a diffset row is anchored on (None otherwise)."""
        return self._anchor.get(handle)

    def sparse_support(self, handle: int) -> int:
        """Stored support of a sparse row (its tid count for a tid-list;
        anchor support minus difference size for a diffset)."""
        return self._ssupport[handle]

    def resolve_tids(self, handle: int) -> np.ndarray:
        """Explicit sorted tid set of ANY row. Tid-lists are returned
        as is; diffsets reconstruct ``tids(anchor) \\ diff`` (walking the
        anchor chain); bitmap rows are scanned — billed as a sparsify
        conversion, since it turns W words into a tid array."""
        rep = int(self._rep[handle])
        if rep == REP_TIDLIST:
            return self._sparse[handle]
        if rep == REP_DIFFSET:
            parent = self.resolve_tids(self._anchor[handle])
            return sorted_difference(parent, self._sparse[handle])
        tids = bitmap_to_tids(self._store[handle])
        with self._lock:
            self.sparsify_ops += 1
            self.sparsify_bytes += self._n_words * 4
        return tids

    def gather_bits_rows(self, tids: np.ndarray,
                         handles: Sequence[int]) -> np.ndarray:
        """[len(handles), len(tids)] bool: bit test of each handle's
        dense row at each tid, read from the host store — the class
        task's batched child carve, one ``np.ix_`` gather for every
        row at once."""
        out = np.zeros((len(handles), len(tids)), bool)
        if not len(tids) or not len(handles) or not self._n_words:
            return out
        t = np.asarray(tids).astype(np.int64)
        w = self._store[np.ix_([int(h) for h in handles], t >> 5)]
        out[:] = (w >> (t & 31).astype(np.uint32)[None, :]) & np.uint32(1)
        return out

    def densify(self, handle: int) -> np.ndarray:
        """Dense word-column of ANY row; for sparse rows this is a billed
        densify conversion."""
        rep = int(self._rep[handle])
        if rep == REP_BITMAP:
            return self._store[handle]
        if rep == REP_TIDLIST:
            out = tids_to_bitmap(self._sparse[handle], self._n_words)
        else:
            out = self.densify(self._anchor[handle]).copy()
            d = self._sparse[handle]
            if len(d):
                np.bitwise_and.at(
                    out, d >> np.uint32(5),
                    ~(np.uint32(1) << (d & np.uint32(31))))
        with self._lock:
            self.densify_ops += 1
            self.densify_bytes += self._n_words * 4
        return out

    def retain(self, handle: int) -> None:
        if handle < self.n_base:
            return                    # pinned item row
        with self._lock:
            self._refs[handle] += 1

    def release(self, handle: int) -> None:
        """Drop one reference; a freed diffset row cascades one release
        to its anchor."""
        h: Optional[int] = handle
        while h is not None:
            h = self._release_one(h)

    def _release_one(self, handle: int) -> Optional[int]:
        if handle < self.n_base:
            return None               # pinned item row
        with self._lock:
            self._refs[handle] -= 1
            if self._refs[handle] == 0:
                self._free.append(handle)
                self.live_extra -= 1
                if self._rep[handle] != REP_BITMAP:
                    t = self._sparse.pop(handle)
                    self.sparse_live -= 1
                    self.sparse_bytes_live -= t.nbytes
                    self._ssupport.pop(handle, None)
                    self._rep[handle] = REP_BITMAP
                    return self._anchor.pop(handle, None)
            elif self._refs[handle] < 0:
                raise RuntimeError(f"double release of handle {handle}")
        return None

    def refcount(self, handle: int) -> int:
        return int(self._refs[handle])

    # ------------------------------------------------------------ access --
    def row(self, handle: int) -> np.ndarray:
        """[n_words] view of one live row; sparse rows densify (billed)."""
        if self._rep[handle] != REP_BITMAP:
            return self.densify(handle)
        return self._store[handle]

    def rows_view(self) -> np.ndarray:
        """Zero-copy [n_rows, n_words] view of the store."""
        return self._store[:self.n_rows]

    def gather(self, handles: Sequence[int]) -> np.ndarray:
        """[len(handles), n_words] rows: a zero-copy slice when the
        handles are consecutive, a fancy-index copy otherwise."""
        h0 = handles[0]
        n = len(handles)
        if all(handles[i] == h0 + i for i in range(1, n)):
            return self._store[h0:h0 + n]
        return self._store[list(handles)]

    @property
    def live_bytes_extra(self) -> int:
        """Retained non-base payload: dense rows at full row width,
        sparse rows at their actual tid-array size."""
        return ((self.live_extra - self.sparse_live) * self._n_words * 4
                + self.sparse_bytes_live)

    @property
    def peak_bytes_extra(self) -> int:
        return self.peak_live_extra * self._n_words * 4

    @property
    def nbytes_base(self) -> int:
        return self.n_base * self._n_words * 4

    # ------------------------------------------------------------ device --
    @property
    def device_enabled(self) -> bool:
        return self.backing != "numpy"

    def device_rows(self) -> Optional[torch.Tensor]:
        """The device mirror ``[n_rows, mirror_words]`` int32, synced
        incrementally (only the dispatcher thread calls this); None for
        a host-only ("numpy") backing.

        Rows appended since the last sync and recycled slots are written;
        a live word-column row among them is billed ``4 * n_words`` bytes
        to ``h2d_bytes``, and a dead or sparse slot is written as zeros,
        unbilled. The mirror is ONE capacity-doubling buffer updated in
        place with ``index_copy_``: a sync moves only the changed rows,
        where a functional update would copy the whole mirror."""
        if not self.device_enabled:
            return None
        tr = self.tracer
        t_sync = time.perf_counter() if tr is not None else 0.0
        with self._lock:
            n = self.n_rows
            todo = sorted(self._stale.union(range(self._dev_n, n)))
            billed = [h for h in todo
                      if (h < self.n_base or self._refs[h] > 0)
                      and self._rep[h] == REP_BITMAP]
            payload = np.zeros((len(todo), self._n_words), np.uint32)
            if billed:
                keep = np.isin(todo, billed)
                payload[keep] = self._store[billed]
            self._stale.clear()
            self._dev_n = n
        mirror = self._mirror
        if mirror is None or mirror.shape[0] < n:
            cap = max(64, n, 0 if mirror is None else 2 * mirror.shape[0])
            grown = torch.zeros((cap, self.mirror_words), dtype=torch.int32,
                                device=self.device)
            if mirror is not None:
                grown[:mirror.shape[0]].copy_(mirror)
            mirror = self._mirror = grown
        if todo:
            idx = torch.as_tensor(todo, dtype=torch.int64).to(self.device)
            mirror[:, :self._n_words].index_copy_(
                0, idx, to_device_words(payload, self.device))
        if billed:
            nbytes = len(billed) * self._n_words * 4
            with self._lock:
                self.h2d_bytes += nbytes
            if tr is not None:
                # only syncs that moved payload get a span: the
                # steady-state no-op sync stays invisible
                tr.span("h2d-sync", t_sync, cat="arena",
                        args={"shard": 0, "segment": 0, "bytes": nbytes})
        return mirror[:n]

    def count_h2d(self, nbytes: int) -> None:
        """Add the host→device payload bytes a backend ships per launch
        (the sparse sweeps' tid arrays, the host-gather path's rows);
        traced as an ``h2d`` instant."""
        with self._lock:
            self.h2d_bytes += nbytes
        if self.tracer is not None:
            self.tracer.instant("h2d", cat="arena",
                                args={"bytes": nbytes})

    def __repr__(self) -> str:
        return (f"<BitmapArena rows={self.n_rows} base={self.n_base} "
                f"live_extra={self.live_extra} backing={self.backing} "
                f"device={self.device}>")
