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
from typing import Dict, List, Optional, Sequence, Tuple

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


def partition_words(n_words_: int, n_hosts: int) -> List[Tuple[int, int]]:
    """Contiguous balanced word ranges ``[(w0, w1), ...]`` over the
    transaction axis, one per host.

    Multi-host mining slices the packed ``[n_items, W]`` database on the
    word (= 32-transaction block) axis: host ``h`` builds its local
    :class:`BitmapArena` from ``bitmaps[:, w0:w1]`` and sweeps only those
    columns. Word granularity keeps every host's slice a plain view with
    no bit surgery, and the remainder is spread over the leading hosts so
    slice widths differ by at most one word. Hosts beyond ``n_words_``
    get empty ``(w, w)`` ranges — legal, the backends skip zero-width
    segments."""
    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    base, extra = divmod(n_words_, n_hosts)
    ranges: List[Tuple[int, int]] = []
    w = 0
    for h in range(n_hosts):
        width = base + (1 if h < extra else 0)
        ranges.append((w, w + width))
        w += width
    return ranges


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
    device mirrors keep it zeroed.

    Segmented transaction axis (streaming ingest): the store is a list
    of per-segment ``[cap, W_seg]`` word-column blocks sharing one slot
    space. :meth:`add_segment` appends a fresh block holding the new
    transactions' packed item bitmaps; older segments are never repacked
    or re-uploaded. A row's logical bitmap is the concatenation of its
    per-segment words; ``cover_of(h)`` is how many leading segments it
    has data in (base rows cover every segment; a pushed row covers the
    segments that existed when it was made, or its ``cover=``, and reads
    as zeros beyond). :meth:`compact` folds leading segments back into
    one block.

    The device mirrors (:meth:`device_rows`) are one int32 tensor per
    segment on ``device``, each kept in sync incrementally: only rows
    appended or recycled since that segment's last sync cross
    host→device, and a live, covering word-column row among them is
    billed ``4 * seg_words`` bytes to ``h2d_bytes``; dead, uncovered and
    sparse rows are placed as zeros, unbilled. Host-only backends never
    call it. ``device=None`` means the CUDA card and raises
    ``RuntimeError`` when there is none; the mirrors live on the CPU only
    when the caller passes ``"cpu"``.

    Device residency (``backing``, one of ``ARENA_BACKINGS``):
      "auto"   a segment's mirror is created lazily by its first
               :meth:`device_rows` call;
      "jax"    the same mirrors, with the base rows uploaded eagerly at
               load and at each :meth:`add_segment` (the reference
               engine's name for it; here an eager upload to
               ``device``);
      "numpy"  host-only: no mirror, :meth:`device_rows` returns None
               and the kernel backend gathers each batch's rows on the
               host and uploads them per launch (the transfer-bound
               baseline).

    ``tracer`` is None (tracing off) unless an engine attaches one; a
    mirror sync that moves payload then records an ``h2d-sync`` span,
    :meth:`count_h2d` an ``h2d`` instant, :meth:`compact` a
    ``compaction`` span and :meth:`migrate` a ``d2d-migrate`` span, on
    the calling lane; the kernel backend reads it to record its
    ``launch`` spans.

    Sharded mode (``n_shards`` > 1, optionally with a ``devices`` list,
    one per shard): one set of per-segment mirrors per shard, on
    ``devices[shard]`` or, for logical shards, all on ``device``. Pinned
    item rows are *replicated* into every shard's mirrors; a row made by
    :meth:`push`, :meth:`materialize` or a sparse push is *owned* by the
    ``shard=`` that made it and lives only in its owner's mirrors. When
    a sweep on shard *s* names a row owned by shard *t*
    (``device_rows(s, needed=...)``), the row is fetched into *s*'s
    mirror (from the host store) and its payload is billed to
    ``d2d_bytes`` once per residency: the modeled cross-device traffic;
    until then it reads as zeros there. :meth:`migrate` re-owners rows
    (a cross-device bucket steal) and bills the same gauge. A host-only
    ("numpy") backing keeps the same ownership and residency bookkeeping
    through :meth:`note_access`.

    Thread-safe: workers push/release concurrently; each shard's mirrors
    are synced by that shard's dispatcher thread and, in a multi-host
    run, by the peers that evaluate flushes on this slice, one sync per
    shard at a time. Growth reallocates the host stores, but handed-out
    row views keep the old buffer alive and live rows are never mutated,
    so views stay content-correct.
    """

    GROW = 2                      # capacity doubling factor

    def __init__(self, n_words_: int,
                 device: "torch.device | str | None" = None,
                 capacity: int = 64, backing: str = "auto",
                 n_shards: int = 1, devices: Optional[Sequence] = None):
        if backing not in ARENA_BACKINGS:
            raise ValueError(
                f"arena backing must be one of {ARENA_BACKINGS}, "
                f"got {backing!r}")
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if devices is not None and len(devices) != n_shards:
            raise ValueError(
                f"devices list ({len(devices)}) must match n_shards "
                f"({n_shards})")
        self.device = resolve_device(device)
        self.backing = backing
        self.n_shards = n_shards
        self.devices = (None if devices is None
                        else [resolve_device(d) for d in devices])
        # observability: None = off (the engines attach a tracer)
        self.tracer = None
        cap = max(capacity, 1)
        # per-segment word-column stores sharing one slot space;
        # segment 0 is the load-time database
        self._seg_words: List[int] = [n_words_]
        # owning tenant per segment (None = default); bookkeeping only —
        # sweeps restrict by explicit segment lists
        self._seg_tenant: List[object] = [None]
        self._stores: List[np.ndarray] = [np.zeros((cap, n_words_),
                                                   np.uint32)]
        self._refs = np.zeros(cap, np.int32)
        self._rep = np.zeros(cap, np.int8)        # REP_* tag per slot
        # owning shard per row; -1 = replicated (pinned base rows)
        self._owner = np.full(cap, -1, np.int32)
        # leading segments a row has data in (see class docstring)
        self._cover = np.zeros(cap, np.int32)
        self.n_rows = 0               # high-water mark (rows ever used)
        self.n_base = 0               # pinned item rows [0, n_base)
        self._free: list = []
        self._lock = threading.Lock()
        # live-row gauges (rows beyond the pinned base — the engine's
        # retained-bitmap memory bound)
        self.live_extra = 0
        self.peak_live_extra = 0
        # per-(shard, segment) mirror state, dicts keyed by segment id so
        # a fresh segment defaults to "nothing synced": rows [0,
        # _dev_n[s][g]) have been placed in mirror (s, g) and are resident
        # there unless in _invalid[s][g], which holds foreign rows never
        # fetched and recycled slots whose mirror content is out of date
        self._mirrors: List[Dict[int, torch.Tensor]] = [
            {} for _ in range(n_shards)]
        self._dev_n: List[Dict[int, int]] = [{} for _ in range(n_shards)]
        self._invalid: List[Dict[int, set]] = [{} for _ in range(n_shards)]
        # rows whose move to this shard was billed as d2d by migrate()
        # but whose payload has not landed in the mirror yet: their
        # placement is free
        self._migrated_in: List[Dict[int, set]] = [
            {} for _ in range(n_shards)]
        # foreign sparse rows whose payload a shard was billed for
        self._sparse_res: List[set] = [set() for _ in range(n_shards)]
        # one mirror sync per shard at a time: a cluster peer evaluates
        # descriptor flushes on this arena from its own thread while
        # this host's dispatcher syncs it
        self._sync_locks = [threading.Lock() for _ in range(n_shards)]
        self.h2d_bytes = 0            # bitmap payload uploaded, total
        self.d2d_bytes = 0            # modeled cross-shard row traffic
        self.migrations = 0           # rows re-owned by migrate()
        self.compaction_bytes = 0     # host bytes repacked by compact()
        self.compactions = 0          # compact() calls that merged
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

    # ---------------------------------------------------------- segments --
    @property
    def n_words(self) -> int:
        """Total logical row width (words) across all segments."""
        return sum(self._seg_words)

    @property
    def n_segments(self) -> int:
        return len(self._seg_words)

    def seg_words(self, seg: int) -> int:
        return self._seg_words[seg]

    def seg_mirror_words(self, seg: int) -> int:
        """Row stride of segment ``seg``'s device mirror: its width
        zero-padded to a power of two. Pad words AND to zero and count
        nothing, and the kernels read only ``seg_words`` of each row;
        the pad keeps every row 16-byte aligned for their 128-bit
        loads."""
        return pow2(self._seg_words[seg])

    @property
    def mirror_words(self) -> int:
        """Row stride of segment 0's mirror (the whole row of an arena
        that was never ingested into)."""
        return self.seg_mirror_words(0)

    def seg_nbytes(self, seg: int) -> int:
        """Payload bytes of one segment's pinned base rows — what an
        ingest must upload to a device mirror (and nothing more)."""
        return self.n_base * self._seg_words[seg] * 4

    def seg_tenant(self, seg: int):
        """Owning tenant of one segment (None = default)."""
        return self._seg_tenant[seg]

    def tenant_segments(self, tenant) -> Tuple[int, ...]:
        """All segment ids owned by ``tenant``, ascending."""
        return tuple(g for g, t in enumerate(self._seg_tenant)
                     if t == tenant)

    def _covered(self, handle: int, seg: int) -> bool:
        return seg < int(self._cover[handle])

    def n_words_upto(self, upto: int) -> int:
        """Total row width (words) of the first ``upto`` segments."""
        return sum(self._seg_words[:upto])

    def seg_tid_range(self, seg: int) -> Tuple[int, int]:
        """[lo, hi) global tid bounds of one segment — the searchsorted
        window a segment-restricted sparse sweep filters tids with."""
        lo = 32 * sum(self._seg_words[:seg])
        return lo, lo + 32 * self._seg_words[seg]

    def add_segment(self, base_bitmaps: np.ndarray, tenant=None) -> int:
        """Append a fresh transaction segment: ``base_bitmaps`` is the
        ``[n_base, W_seg]`` packed item bitmaps of the NEW transactions
        only. Existing segments are untouched — no repack, no re-upload;
        under ``backing="jax"`` the new segment's base rows are mirrored
        at once and their bytes (exactly :meth:`seg_nbytes`) are the
        whole h2d bill. ``tenant`` tags the segment's owner (None =
        default). Returns the new segment id."""
        bm = np.ascontiguousarray(base_bitmaps, dtype=np.uint32)
        if bm.ndim != 2 or bm.shape[0] != self.n_base:
            raise ValueError(
                f"segment bitmaps must be [n_base={self.n_base}, W_seg], "
                f"got {bm.shape}")
        with self._lock:
            w = bm.shape[1]
            seg = len(self._seg_words)
            store = np.zeros((self._refs.shape[0], w), np.uint32)
            store[:self.n_base] = bm
            self._seg_words.append(w)
            self._seg_tenant.append(tenant)
            self._stores.append(store)
            # base rows extend into the new segment; live non-base rows
            # keep their coverage and read as zeros there
            self._cover[:self.n_base] = seg + 1
        if self.backing == "jax":
            for shard in range(self.n_shards):
                self.device_rows(shard, segment=seg)   # eager, W_seg only
        return seg

    def compact(self, upto: int) -> int:
        """Merge the first ``upto`` segments into one wide word-column
        store (LSM-style). Handles, refcounts and the free list are
        untouched; only the segment axis collapses. Segments at index >=
        ``upto`` shift down by ``upto - 1``, and a row that covered any
        merged segment now covers the merged block (its store words
        beyond its old coverage are zero, so reads stay identical). Host
        repack bytes are billed to ``compaction_bytes``. Each shard's
        mirrors are merged on its device up to their least-synced row
        count; rows beyond it re-sync (and re-bill) at the next
        :meth:`device_rows`.

        Must not run concurrently with sweeps that hold segment ids (the
        streaming engine serializes it with refresh and ingest, and
        gates it behind in-flight query sweeps). Refuses (returns 0)
        when the merged segments belong to more than one tenant.
        Returns the number of segments removed (``upto - 1``)."""
        tr = self.tracer
        t0 = time.perf_counter() if tr is not None else 0.0
        with self._lock:
            if not 2 <= upto <= len(self._seg_words):
                return 0
            if len(set(self._seg_tenant[:upto])) > 1:
                return 0
            old_w = self._seg_words[:upto]
            new_w = sum(old_w)
            merged = np.concatenate(self._stores[:upto], axis=1)
            self._stores[:upto] = [np.ascontiguousarray(merged)]
            self._seg_words[:upto] = [new_w]
            self._seg_tenant[:upto] = [self._seg_tenant[0]]
            self.compaction_bytes += self.n_rows * new_w * 4
            self.compactions += 1
            # cover remap: >= upto -> minus (upto-1); in (0, upto) -> 1
            cov = self._cover
            self._cover = np.where(cov >= upto, cov - (upto - 1),
                                   np.minimum(cov, 1)).astype(np.int32)
            for shard in range(self.n_shards):
                self._merge_mirror(shard, upto, old_w)
            if tr is not None:
                tr.span("compaction", t0, cat="arena",
                        args={"merged": upto,
                              "bytes": self.n_rows * new_w * 4})
            return upto - 1

    def _merge_mirror(self, shard: int, upto: int,
                      old_w: Sequence[int]) -> None:
        # caller holds self._lock
        def _remap(d: dict, merged) -> dict:
            out = {} if merged is None else {0: merged}
            for g in sorted(k for k in d if k >= upto):
                out[g - (upto - 1)] = d[g]
            return out

        dn, mirrors = self._dev_n[shard], self._mirrors[shard]
        nmin = min(dn.get(g, 0) for g in range(upto))
        # a row invalid in ANY merged segment is invalid in the merged
        # block; a prepaid migration into any of them stays prepaid
        inv, mig = set(), set()
        for g in range(upto):
            inv |= {h for h in self._invalid[shard].get(g, ()) if h < nmin}
            mig |= self._migrated_in[shard].get(g, set())
        self._migrated_in[shard] = _remap(self._migrated_in[shard], mig)
        blocks = [mirrors.get(g) for g in range(upto)]
        if not self.device_enabled:
            # host-only: the residency bookkeeping merges, no mirrors
            self._dev_n[shard] = _remap(dn, nmin)
            self._invalid[shard] = _remap(self._invalid[shard], inv)
        elif nmin > 0 and all(b is not None for b in blocks):
            # each block's first seg_words columns only: a mirror row's
            # pad words past them would land inside the merged row
            new_w = sum(old_w)
            buf = torch.zeros((max(64, blocks[0].shape[0]), pow2(new_w)),
                              dtype=torch.int32,
                              device=self.shard_device(shard))
            buf[:nmin, :new_w] = torch.cat(
                [b[:nmin, :w] for b, w in zip(blocks, old_w)], dim=1)
            self._mirrors[shard] = _remap(mirrors, buf)
            self._dev_n[shard] = _remap(dn, nmin)
            self._invalid[shard] = _remap(self._invalid[shard], inv)
        else:
            # nothing fully mirrored yet: the merged block re-syncs from
            # scratch at its next device_rows
            self._mirrors[shard] = _remap(mirrors, None)
            self._dev_n[shard] = _remap(dn, None)
            self._invalid[shard] = _remap(self._invalid[shard], None)

    # ------------------------------------------------------------- load --
    @classmethod
    def from_bitmaps(cls, bitmaps: np.ndarray,
                     device: "torch.device | str | None" = None,
                     backing: str = "auto", n_shards: int = 1,
                     devices: Optional[Sequence] = None) -> "BitmapArena":
        """Load packed item bitmaps as the pinned base rows (handle ==
        item id). One copy, once; ``backing="jax"`` also uploads them to
        every shard's mirror now (they are replicated)."""
        n, w = bitmaps.shape
        arena = cls(w, device, capacity=max(64, 2 * n), backing=backing,
                    n_shards=n_shards, devices=devices)
        arena._stores[0][:n] = bitmaps
        arena._refs[:n] = 1
        arena._cover[:n] = 1
        arena.n_rows = arena.n_base = n
        if backing == "jax":
            for shard in range(n_shards):
                arena.device_rows(shard)
        return arena

    @classmethod
    def from_database(cls, db: Sequence[Sequence[int]], n_items: int,
                      device: "torch.device | str | None" = None,
                      backing: str = "auto", n_shards: int = 1,
                      devices: Optional[Sequence] = None) -> "BitmapArena":
        """pack_database straight into the arena (no intermediate)."""
        return cls.from_bitmaps(pack_database(db, n_items), device,
                                backing, n_shards, devices)

    # ------------------------------------------------------ row lifecycle --
    def _alloc_slot(self) -> int:
        # caller holds self._lock
        if self._free:
            slot = self._free.pop()
            for shard in range(self.n_shards):
                for g, n in self._dev_n[shard].items():
                    if slot < n:          # mirror content now out of date
                        self._invalid[shard].setdefault(g, set()).add(slot)
                for mig in self._migrated_in[shard].values():
                    mig.discard(slot)     # the old row is gone
            return slot
        if self.n_rows == self._refs.shape[0]:
            cap = self.GROW * self._refs.shape[0]
            for g, old in enumerate(self._stores):
                store = np.zeros((cap, self._seg_words[g]), np.uint32)
                store[:self.n_rows] = old[:self.n_rows]
                self._stores[g] = store
            refs = np.zeros(cap, np.int32)
            refs[:self.n_rows] = self._refs[:self.n_rows]
            rep = np.zeros(cap, np.int8)
            rep[:self.n_rows] = self._rep[:self.n_rows]
            cover = np.zeros(cap, np.int32)
            cover[:self.n_rows] = self._cover[:self.n_rows]
            owner = np.full(cap, -1, np.int32)
            owner[:self.n_rows] = self._owner[:self.n_rows]
            self._refs, self._rep, self._cover = refs, rep, cover
            self._owner = owner
        slot = self.n_rows
        self.n_rows += 1
        return slot

    def _bump_live(self) -> None:
        self.live_extra += 1
        self.peak_live_extra = max(self.peak_live_extra, self.live_extra)

    def _check_row(self, shard: int, cover: Optional[int]) -> int:
        """The coverage a new row gets: ``cover``, or every segment.
        Raises for a shard outside the arena's or a coverage past the
        last segment."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard={shard} outside the arena's "
                             f"{self.n_shards} shards")
        n = len(self._seg_words)
        if cover is None:
            return n
        if not 0 <= cover <= n:
            raise ValueError(f"cover={cover} outside the arena's "
                             f"{n} segments")
        return cover

    def push(self, row: np.ndarray, shard: int = 0,
             cover: Optional[int] = None) -> int:
        """Append (or recycle a slot for) one bitmap row; refcount 1.
        ``shard`` owns the row. Without ``cover``, ``row`` is the
        full-width concatenation over all segments; with ``cover=c`` it
        spans only the first ``c`` segments (:meth:`n_words_upto`) and
        the slot is zeroed beyond — a refresh pushes rows at its
        generation boundary even after an ingest has appended newer
        segments."""
        with self._lock:
            cov = self._check_row(shard, cover)
            slot = self._alloc_slot()
            off = 0
            for g, w in enumerate(self._seg_words):
                if g < cov:
                    self._stores[g][slot] = row[off:off + w]
                    off += w
                else:
                    self._stores[g][slot] = 0
            self._refs[slot] = 1
            self._owner[slot] = shard
            self._cover[slot] = cov
            self._rep[slot] = REP_BITMAP
            self._bump_live()
            return slot

    def materialize(self, prefix_handle: int, ext_handle: int,
                    shard: int = 0) -> int:
        """``row(prefix) ∧ row(ext)`` written in place into a fresh slot
        — the depth-first parent→child handoff, with no floating
        temporary. ``shard`` (the materializing worker's) owns it; it
        covers the segments both parents cover (and is zeroed beyond).
        The device mirrors pick it up at their next sync, billed like any
        pushed row."""
        with self._lock:
            self._check_row(shard, None)
            slot = self._alloc_slot()
            cov = min(int(self._cover[prefix_handle]),
                      int(self._cover[ext_handle]))
            for g, store in enumerate(self._stores):
                if g < cov:
                    np.bitwise_and(store[prefix_handle], store[ext_handle],
                                   out=store[slot])
                else:
                    store[slot] = 0
            self._refs[slot] = 1
            self._owner[slot] = shard
            self._cover[slot] = cov
            self._rep[slot] = REP_BITMAP
            self._bump_live()
            return slot

    # ------------------------------------------------- sparse lifecycle --
    def _push_sparse(self, rep: int, tids: np.ndarray, support: int,
                     shard: int, cover: Optional[int],
                     anchor: Optional[int] = None) -> int:
        t = np.ascontiguousarray(tids, dtype=np.uint32)
        with self._lock:
            cov = self._check_row(shard, cover)
            slot = self._alloc_slot()
            self._refs[slot] = 1
            self._owner[slot] = shard
            self._cover[slot] = cov
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

    def sparsify_push(self, row: np.ndarray, shard: int = 0,
                      cover: Optional[int] = None) -> int:
        """Scan a dense word-row into a tid-list row (billed sparsify
        conversion) — the prefix cache's path when the density model
        says a freshly built intersection should live sparse."""
        t = bitmap_to_tids(row)
        with self._lock:
            self.sparsify_ops += 1
            self.sparsify_bytes += row.nbytes
        return self.push_tids(t, shard=shard, cover=cover)

    def rep_of(self, handle: int) -> int:
        """REP_BITMAP / REP_TIDLIST / REP_DIFFSET tag of a row."""
        return int(self._rep[handle])

    def rep_name(self, handle: int) -> str:
        return REP_NAMES[self.rep_of(handle)]

    def cover_of(self, handle: int) -> int:
        """Leading segments a row has data in."""
        return int(self._cover[handle])

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
        tids = bitmap_to_tids(self.row(handle))
        with self._lock:
            self.sparsify_ops += 1
            self.sparsify_bytes += self.n_words * 4
        return tids

    def gather_bits_rows(self, tids: np.ndarray,
                         handles: Sequence[int]) -> np.ndarray:
        """[len(handles), len(tids)] bool: bit test of each handle's
        dense row at each tid, read from the host stores — the class
        task's batched child carve, one ``np.ix_`` gather per segment
        for every row at once."""
        out = np.zeros((len(handles), len(tids)), bool)
        if not len(tids) or not len(handles):
            return out
        hs = [int(h) for h in handles]
        for g in range(self.n_segments):
            if not self._seg_words[g]:
                continue
            lo, hi = self.seg_tid_range(g)
            i0, i1 = np.searchsorted(tids, [lo, hi])
            if i0 == i1:
                continue
            t = tids[i0:i1].astype(np.int64) - lo
            w = self.seg_view(g)[np.ix_(hs, t >> 5)]
            out[:, i0:i1] = (w >> (t & 31).astype(np.uint32)[None, :]
                             ) & np.uint32(1)
        return out

    def densify(self, handle: int) -> np.ndarray:
        """Full-width dense word-column of ANY row; for sparse rows this
        is a billed densify conversion."""
        rep = int(self._rep[handle])
        if rep == REP_BITMAP:
            return self.row(handle)
        if rep == REP_TIDLIST:
            out = tids_to_bitmap(self._sparse[handle], self.n_words)
        else:
            out = self.densify(self._anchor[handle]).copy()
            d = self._sparse[handle]
            if len(d):
                np.bitwise_and.at(
                    out, d >> np.uint32(5),
                    ~(np.uint32(1) << (d & np.uint32(31))))
        with self._lock:
            self.densify_ops += 1
            self.densify_bytes += self.n_words * 4
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
                    for res in self._sparse_res:
                        res.discard(handle)
                    return self._anchor.pop(handle, None)
            elif self._refs[handle] < 0:
                raise RuntimeError(f"double release of handle {handle}")
        return None

    def refcount(self, handle: int) -> int:
        return int(self._refs[handle])

    # ------------------------------------------------------------ access --
    def row(self, handle: int) -> np.ndarray:
        """[n_words] view of one live row. Zero-copy for a one-segment
        arena; for a segmented arena a concatenated copy, zero past the
        row's coverage. Sparse rows densify (billed)."""
        if self._rep[handle] != REP_BITMAP:
            return self.densify(handle)
        return self.row_upto(handle, len(self._stores))

    def row_upto(self, handle: int, upto: int) -> np.ndarray:
        """Row words over the first ``upto`` segments only, zero past
        the row's coverage — the boundary-consistent read of a refresh
        that overlaps an ingest (segments appended after the boundary
        are invisible, so two reads of one handle agree in width)."""
        if self._rep[handle] != REP_BITMAP:
            return self.densify(handle)[:self.n_words_upto(upto)]
        if upto == 1:
            return self._stores[0][handle]
        cov = int(self._cover[handle])
        return np.concatenate(
            [store[handle] if g < cov
             else np.zeros(self._seg_words[g], np.uint32)
             for g, store in enumerate(self._stores[:upto])])

    def seg_row(self, seg: int, handle: int) -> np.ndarray:
        """Zero-copy [W_seg] view of one row's words in one segment."""
        return self._stores[seg][handle]

    def seg_view(self, seg: int) -> np.ndarray:
        """Zero-copy [n_rows, W_seg] view of one segment's store."""
        return self._stores[seg][:self.n_rows]

    def rows_view(self) -> np.ndarray:
        """[n_rows, n_words] view of the whole store: zero-copy for a
        one-segment arena, a concatenated copy otherwise."""
        if len(self._stores) == 1:
            return self._stores[0][:self.n_rows]
        return np.concatenate([s[:self.n_rows] for s in self._stores],
                              axis=1)

    def seg_gather(self, seg: int, handles: Sequence[int]) -> np.ndarray:
        """One segment's rows for ``handles``: a zero-copy slice when
        the handles are consecutive, a fancy-index copy otherwise."""
        store = self._stores[seg]
        h0 = handles[0]
        n = len(handles)
        if all(handles[i] == h0 + i for i in range(1, n)):
            return store[h0:h0 + n]
        return store[list(handles)]

    def gather(self, handles: Sequence[int]) -> np.ndarray:
        """Full-width rows for ``handles`` (see :meth:`seg_gather`)."""
        if len(self._stores) == 1:
            return self.seg_gather(0, handles)
        return np.concatenate([self.seg_gather(g, handles)
                               for g in range(len(self._stores))], axis=1)

    @property
    def live_bytes_extra(self) -> int:
        """Retained non-base payload: dense rows at full row width,
        sparse rows at their actual tid-array size."""
        return ((self.live_extra - self.sparse_live) * self.n_words * 4
                + self.sparse_bytes_live)

    @property
    def peak_bytes_extra(self) -> int:
        return self.peak_live_extra * self.n_words * 4

    @property
    def nbytes_base(self) -> int:
        return self.n_base * self.n_words * 4

    # ------------------------------------------------------------ device --
    @property
    def device_enabled(self) -> bool:
        return self.backing != "numpy"

    def shard_device(self, shard: int) -> torch.device:
        """Where shard ``shard``'s mirrors live: its entry of
        ``devices``, or ``device`` for logical shards."""
        return self.device if self.devices is None else self.devices[shard]

    def owner_of(self, handle: int) -> int:
        """Owning shard of a row; -1 for replicated (pinned base) rows."""
        if handle < self.n_base:
            return -1
        return int(self._owner[handle])

    def migrate(self, handles: Sequence[int], dst: int) -> int:
        """Re-owner rows onto shard ``dst`` — the explicit transfer
        behind a cross-device bucket steal. A row's payload is billed to
        ``d2d_bytes`` once per crossing: a row ``dst`` already holds in
        its mirror flips owner for free, and a row billed here lands in
        ``dst``'s mirror later at no further h2d or d2d cost. Pinned base
        rows are replicated and never move. Returns the rows moved."""
        moved = 0
        tr = self.tracer
        t0 = time.perf_counter() if tr is not None else 0.0
        d2d0 = self.d2d_bytes
        with self._lock:
            dn, inv = self._dev_n[dst], self._invalid[dst]
            mig = self._migrated_in[dst]
            for h in handles:
                if h < self.n_base or int(self._owner[h]) == dst:
                    continue
                self._owner[h] = dst
                if self._rep[h] != REP_BITMAP:
                    # sparse payload crosses once, at its actual size
                    if h not in self._sparse_res[dst]:
                        self.d2d_bytes += self._sparse[h].nbytes
                        self._sparse_res[dst].add(h)
                else:
                    for g in range(int(self._cover[h])):
                        wb = self._seg_words[g] * 4
                        if wb and not (h < dn.get(g, 0)
                                       and h not in inv.get(g, ())):
                            self.d2d_bytes += wb
                            mig.setdefault(g, set()).add(h)
                self.migrations += 1
                moved += 1
        if tr is not None and moved:
            tr.span("d2d-migrate", t0, cat="arena",
                    args={"rows": moved, "dst": dst,
                          "bytes": self.d2d_bytes - d2d0})
        return moved

    def _sync_plan(self, shard: int, seg: int,
                   needed: Optional[Sequence[int]]
                   ) -> Tuple[int, int, List[int], int, List[int],
                              List[int]]:
        """Advance mirror (shard, seg)'s bookkeeping to ``n_rows`` and
        sort its work (caller holds the lock). Returns ``(lo, n,
        fresh_owned, fresh_h2d, reupload, fetch)``: rows [lo, n) are new
        to the mirror, of which ``fresh_owned`` (owned by the shard or
        replicated, live, covering the segment, word-column) carry
        payload, ``fresh_h2d`` of them billed as h2d (the rest were
        prepaid by :meth:`migrate`), and the others enter ``_invalid``;
        ``reupload`` are owned rows whose mirror content went stale,
        billed as h2d; ``fetch`` are rows placed without an h2d bill:
        foreign rows ``needed`` now (billed to ``d2d_bytes`` here, once
        per residency), prepaid migrations, and dead, uncovered or
        sparse rows, which carry no payload. Without ``needed`` every
        stale owned row is refreshed and foreign rows wait."""
        n = self.n_rows
        lo = self._dev_n[shard].get(seg, 0)
        inv = self._invalid[shard].setdefault(seg, set())
        mig = self._migrated_in[shard].setdefault(seg, set())
        fresh_owned: List[int] = []
        fresh_h2d = 0

        def _live(h: int) -> bool:
            return h < self.n_base or int(self._refs[h]) > 0

        def _owned(h: int) -> bool:
            return h < self.n_base or int(self._owner[h]) in (-1, shard)

        for h in range(lo, n):
            if (_owned(h) and _live(h) and self._covered(h, seg)
                    and self._rep[h] == REP_BITMAP):
                fresh_owned.append(h)
                if h in mig:              # transfer billed by migrate
                    mig.discard(h)
                else:
                    fresh_h2d += 1
            else:
                inv.add(h)
        self._dev_n[shard][seg] = n
        reupload: List[int] = []
        fetch: List[int] = []
        row_bytes = self._seg_words[seg] * 4

        def _classify(h: int) -> None:
            inv.discard(h)
            if (not (_live(h) and self._covered(h, seg))
                    or self._rep[h] != REP_BITMAP):
                fetch.append(h)           # no word-column payload
            elif _owned(h):
                if h in mig:              # prepaid migration landing
                    mig.discard(h)
                    fetch.append(h)
                else:
                    reupload.append(h)
            else:
                fetch.append(h)
                self.d2d_bytes += row_bytes

        if needed is not None:
            for h in set(needed):
                if h in inv:
                    _classify(h)
        else:
            for h in sorted(inv):
                if _owned(h):
                    _classify(h)
        return lo, n, fresh_owned, fresh_h2d, reupload, fetch

    def note_access(self, shard: int, handles: Sequence[int],
                    segments: Optional[Sequence[int]] = None) -> None:
        """Residency and d2d bookkeeping for host-only sweeps: a sweep on
        ``shard`` reading a row owned elsewhere bills one cross-shard
        fetch to ``d2d_bytes``, after which the row is resident there
        until its slot recycles. ``segments`` restricts the bill to the
        segments actually swept. A device-backed arena does the same
        bookkeeping, and the mirror writes, in :meth:`device_rows`."""
        if self.n_shards == 1:
            return
        with self._lock:
            self._note_sparse(shard, handles)
            for g in (segments if segments is not None
                      else range(len(self._seg_words))):
                self._sync_plan(shard, g, handles)

    def _note_sparse(self, shard: int, handles: Sequence[int]) -> None:
        """A foreign tid/diffset payload read by ``shard`` is billed to
        ``d2d_bytes`` once per residency, at its actual size (caller
        holds the lock)."""
        res = self._sparse_res[shard]
        for h in set(handles):
            if (self._rep[h] != REP_BITMAP and h not in res
                    and int(self._owner[h]) not in (-1, shard)):
                t = self._sparse.get(h)
                if t is not None:
                    self.d2d_bytes += t.nbytes
                    res.add(h)

    def device_rows(self, shard: int = 0,
                    needed: Optional[Sequence[int]] = None,
                    segment: int = 0) -> Optional[torch.Tensor]:
        """Shard ``shard``'s mirror of segment ``segment``, ``[n_rows,
        seg_mirror_words]`` int32 on :meth:`shard_device`, synced
        incrementally (by that shard's dispatcher thread, and a cluster
        peer's evaluator); None for a host-only ("numpy") backing, which
        books ``needed`` through :meth:`note_access` instead.

        ``needed`` lists the handles the caller is about to read:
        foreign rows among them are fetched into this mirror and billed
        to ``d2d_bytes``; a foreign row not yet fetched reads as zeros.
        Rows new to the mirror and its stale owned slots are written; an
        owned live word-column row covering the segment is billed ``4 *
        seg_words`` bytes to ``h2d_bytes`` (unless a migration prepaid
        it), and a dead, uncovered or sparse slot is written as zeros,
        unbilled. So an ingest that appended segment g uploads
        ``seg_nbytes(g)`` per shard and never the older segments. Each
        mirror is ONE capacity-doubling buffer updated in place with
        ``index_copy_``: a sync moves only the changed rows. Syncs of
        one shard serialize on its lock."""
        if not self.device_enabled:
            if needed is not None:
                self.note_access(shard, needed, segments=(segment,))
            return None
        with self._sync_locks[shard]:
            return self._sync(shard, segment, needed)

    def _sync(self, shard: int, segment: int,
              needed: Optional[Sequence[int]]) -> torch.Tensor:
        tr = self.tracer
        t_sync = time.perf_counter() if tr is not None else 0.0
        w = self._seg_words[segment]
        dev = self.shard_device(shard)
        with self._lock:
            if needed is not None:
                self._note_sparse(shard, needed)
            lo, n, fresh_owned, fresh_h2d, reupload, fetch = \
                self._sync_plan(shard, segment, needed)
            # row -> whether it carries payload; a later entry wins (a
            # fresh foreign row may also be fetched in this sync)
            write = dict.fromkeys(range(lo, n), False)
            write.update(dict.fromkeys(fresh_owned, True))
            write.update(dict.fromkeys(reupload, True))
            for h in fetch:
                write[h] = bool((h < self.n_base or self._refs[h] > 0)
                                and self._rep[h] == REP_BITMAP
                                and self._covered(h, segment))
            todo = sorted(write)
            payload = np.zeros((len(todo), w), np.uint32)
            real = [h for h in todo if write[h]]
            if real:
                payload[[write[h] for h in todo]] = \
                    self._stores[segment][real]
        mirrors = self._mirrors[shard]
        mirror = mirrors.get(segment)
        if mirror is None or mirror.shape[0] < n:
            cap = max(64, n, 0 if mirror is None else 2 * mirror.shape[0])
            grown = torch.zeros((cap, pow2(w)), dtype=torch.int32,
                                device=dev)
            if mirror is not None:
                grown[:mirror.shape[0]].copy_(mirror)
            mirror = mirrors[segment] = grown
        if todo and w:
            idx = torch.as_tensor(todo, dtype=torch.int64).to(dev)
            mirror[:, :w].index_copy_(0, idx, to_device_words(payload, dev))
        nbytes = (fresh_h2d + len(reupload)) * w * 4
        if nbytes:
            with self._lock:
                self.h2d_bytes += nbytes
            if tr is not None:
                # only syncs that moved payload get a span: the
                # steady-state no-op sync stays invisible
                tr.span("h2d-sync", t_sync, cat="arena",
                        args={"shard": shard, "segment": segment,
                              "bytes": nbytes})
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
                f"shards={self.n_shards} segments={self.n_segments} "
                f"device={self.device}>")
