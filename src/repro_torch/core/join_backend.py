"""Batched join backends + the sweep dispatcher.

A *bucket sweep* is the paper's per-task TID join restructured at bucket
granularity: one (k-1)-prefix bitmap against the bucket's E extension
bitmaps, producing E support counts in one call. Two pieces carry it:

  ``BitmapArena`` (repro_torch.core.tidlist)  every bitmap lives in one
      refcounted row store with integer handles; its device mirror is
      synced incrementally, so repeated sweeps cost ~one initial upload.
  ``SweepDispatcher``  workers enqueue handle-based ``SweepRequest``s
      and block on a future; one dispatcher thread per arena shard
      coalesces its pending requests into a batch and launches one kernel
      per representation for all of them, each through a backend of its
      own. Only the dispatcher threads touch the device. Depth-first
      class sweeps (``sweep_bits``) take the same queue on the kernel
      backend and run inline on the calling worker on the host backend.

Backends implement the same batched API:

  numpy   per-request ``tidlist.support_counts`` over zero-copy arena
          row views — GIL-released ufunc passes on the host. It runs
          only when asked for by name.
  torch   the kernel backend: dense prefixes (one row or a tuple of
          rows) go to ``bitmap_join_many`` and sparse (tid-list/diffset)
          prefixes to ``gather_intersect_many``, launched once per
          transaction segment a flush touches; their indexed entries read
          prefix and extension rows from that segment's device mirror by
          handle. An arena with
          no mirror (backing "numpy") has each batch's rows gathered on
          the host and uploaded per launch to the kernels' gathered
          forms. On a CUDA arena the wrappers launch the CUDA kernels; on
          a CPU arena they run their plain versions.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import tidlist
from repro_torch.core.tidlist import BitmapArena, pow2
from repro_torch.kernels.bitmap_join.ops import (bitmap_join_many,
                                                 bitmap_join_many_rows)
from repro_torch.kernels.gather_intersect.ops import (
    gather_intersect_many, gather_intersect_many_rows)
from repro_torch.obs import schema as obs_schema

# Dispatcher defaults: how many requests one kernel launch may carry,
# and how long (µs) the dispatcher waits for stragglers to coalesce
# before flushing a partial batch.
MAX_BATCH = 32
FLUSH_US = 200.0
# Straggler cap once a QUERY-class (priority) request is pending: a
# serving query still coalesces into whatever flush is forming, but it
# does not sit out the full mining straggler window — the p99 a lone
# query pays is bounded by this, not FLUSH_US.
QUERY_FLUSH_US = 50.0


@dataclass
class SweepRequest:
    """One bucket sweep, by handle: counts[i] = |P ∧ row(ext_i)|.

    ``prefix_handle`` is one arena handle (``P`` is its row: a cached or
    materialized prefix, or a base item row), or a TUPLE of handles whose
    rows the backend AND-reduces per segment (``P`` is their
    intersection): the streaming engine's delta and query sweeps name
    base-item tuples, so a sweep over a few fresh words never builds a
    full-width prefix intersection first. ``prefix_handles`` is the
    prefix as a tuple either way.

    ``shard`` is the arena shard the request runs on, stamped by the
    (per-shard) dispatcher that accepted it, so the backend reads that
    shard's mirror and books the request's foreign rows to it.

    ``segments`` restricts the join to a subset of the arena's
    transaction segments (None = all; ``segment_ids`` resolves it): the
    streaming engine's delta sweeps read only the freshly ingested
    segments, and its fresh sweeps only the refresh's generation
    boundary. The backend launches once per segment a flush touches and
    sums the counts.

    When ``prefix_handle`` is a SPARSE arena row (tid-list or diffset),
    the backend runs the gather-intersect path and the counts are
    ``|payload ∩ ext_i|`` over the raw sparse payload — for a tid-list
    that IS the support, for a diffset it is the subtrahend. One flush
    may mix representations; the backend partitions per launch. Tuple
    prefixes are always dense.

    ``priority`` marks a QUERY-class request (the serving layer's
    unknown-itemset sweeps): it goes to the front of the pending queue
    and caps the dispatcher's straggler wait at ``QUERY_FLUSH_US``.

    ``desc`` is the request's portable descriptor for multi-host runs:
    the prefix as base ITEM ids, meaningful on any host's arena slice.
    Arena handles are host-local (a cached prefix row exists only on the
    host that built it), so the cluster's cross-host reduction
    re-evaluates the flush from descriptors; call sites sweeping a
    derived handle pass the prefix itemset here. Tuple prefixes and
    base-row handles describe themselves; single-host runs ignore it.

    ``flush`` and ``flush_t0`` are stamped by a traced dispatcher: the
    id of the flush that carried the request (``Tracer.serial``) and
    that flush's start on the tracer's clock; an untraced run leaves
    them at 0."""
    prefix_handle: "int | Tuple[int, ...]"
    ext_handles: Tuple[int, ...]
    shard: int = 0
    segments: Optional[Tuple[int, ...]] = None
    priority: bool = False
    desc: Optional[Tuple[int, ...]] = None
    future: Future = field(default_factory=Future)
    flush: int = 0
    flush_t0: float = 0.0

    @property
    def prefix_handles(self) -> Tuple[int, ...]:
        p = self.prefix_handle
        return p if isinstance(p, tuple) else (p,)

    @property
    def rows(self) -> Tuple[int, ...]:
        """Every arena row the request reads."""
        return (*self.prefix_handles, *self.ext_handles)

    def segment_ids(self, arena: BitmapArena) -> Tuple[int, ...]:
        if self.segments is not None:
            return self.segments
        return tuple(range(arena.n_segments))

    def is_sparse(self, arena: BitmapArena) -> bool:
        """True when the prefix row is a tid-list/diffset; tuple prefixes
        AND base rows and are always dense."""
        p = self.prefix_handle
        return (not isinstance(p, tuple)
                and arena.rep_of(p) != tidlist.REP_BITMAP)


class JoinBackend:
    """Batched executor: ``sweep_many(arena, requests)`` returns one
    int64 counts array per request (ragged — each sized to the
    request's own extension count). ``host_parallel`` backends run on
    the host with the GIL released, so a worker may call them on its
    own thread; the others run only on the dispatcher thread."""

    name: str = "base"
    host_parallel: bool = False

    def sweep_many(self, arena: BitmapArena,
                   requests: Sequence[SweepRequest]) -> List[np.ndarray]:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<JoinBackend {self.name}>"


class NumpyBackend(JoinBackend):
    """Zero-copy arena row views into the fused AND+popcount ufunc pass,
    batched: a flush's dense requests are grouped per segment and binned
    by padded (L, E), and each bin executes as a few wide numpy passes
    (index gather → AND-reduce → fused popcount); sparse requests gather
    one word per tid. On a sharded arena each request's rows are booked
    to its shard first (foreign reads bill ``d2d_bytes``)."""

    name = "numpy"
    host_parallel = True
    # bound on a bin pass's [B, E, W] AND temporary (slices B)
    PASS_BYTES = 4 << 20

    def sweep_many(self, arena, requests):
        if arena.n_shards > 1:
            # per request: a delta sweep bills only the segments it reads
            for r in requests:
                arena.note_access(r.shard, r.rows, segments=r.segments)
        totals: List[Optional[np.ndarray]] = [None] * len(requests)
        by_seg: Dict[int, List[int]] = {}
        for i, r in enumerate(requests):
            if r.is_sparse(arena):
                totals[i] = self._sweep_sparse(arena, r)
                continue
            for g in r.segment_ids(arena):
                if arena.seg_words(g):   # skip zero-width segments
                    by_seg.setdefault(g, []).append(i)
        for g, idxs in sorted(by_seg.items()):
            rows = arena.seg_view(g)
            if len(idxs) == 1:
                i = idxs[0]
                c = self._sweep_one(rows, requests[i])
                totals[i] = c if totals[i] is None else totals[i] + c
                continue
            # bin by padded (L, E) so one fancy-index gather serves the
            # bin without per-request ragged handling
            bins: Dict[Tuple[int, int], List[int]] = {}
            for i in idxs:
                r = requests[i]
                key = (pow2(len(r.prefix_handles)), pow2(len(r.ext_handles)))
                bins.setdefault(key, []).append(i)
            for (lp, ep), bi in sorted(bins.items()):
                counts = self._sweep_bin(rows, [requests[i] for i in bi],
                                         lp, ep)
                for j, i in enumerate(bi):
                    c = counts[j, :len(requests[i].ext_handles)]
                    totals[i] = c if totals[i] is None else totals[i] + c
        return [t if t is not None else np.zeros(len(r.ext_handles), np.int64)
                for t, r in zip(totals, requests)]

    @staticmethod
    def sweep_sparse_bits(arena, r):
        """Full sparse-prefix sweep that also returns its bit matrix:
        gather the ext word at every prefix tid and test one bit — an
        [E, S] bit matrix, no [E, W] dense gather copy. Returns
        ``(counts, bits)``, the bit columns aligned with the prefix's
        sorted payload: a depth-first class task counts with it and
        carves its children from it without gathering again."""
        bits = arena.gather_bits_rows(arena.tids_of(r.prefix_handle),
                                      r.ext_handles)
        return bits.sum(axis=1, dtype=np.int64), bits

    @staticmethod
    def _sweep_sparse(arena, r):
        """Sparse-prefix sweep over the request's segments: the sorted
        tid payload is searchsorted into each segment's global tid
        window, and ``np.ix_`` outer-indexes the segment store into an
        [E, S] word block — no [E, W] dense gather copy."""
        out = np.zeros(len(r.ext_handles), np.int64)
        tids = arena.tids_of(r.prefix_handle)
        if not len(tids) or not len(r.ext_handles):
            return out
        eh = list(r.ext_handles)
        for g in r.segment_ids(arena):
            if not arena.seg_words(g):
                continue
            lo, hi = arena.seg_tid_range(g)
            i0, i1 = np.searchsorted(tids, [lo, hi])
            if i0 == i1:
                continue
            t = tids[i0:i1].astype(np.int64) - lo
            words = arena.seg_view(g)[np.ix_(eh, t >> 5)]       # [E, S]
            out += ((words >> (t & 31).astype(np.uint32)[None, :])
                    & np.uint32(1)).sum(axis=1, dtype=np.int64)
        return out

    @staticmethod
    def _sweep_one(rows, r):
        """Single-request path: no padding copies, and
        ``support_counts`` chunks its own [E, W] temporary."""
        ph = r.prefix_handles
        prefix = rows[ph[0]]
        for h in ph[1:]:              # tuple prefix: AND per segment
            prefix = prefix & rows[h]
        return tidlist.support_counts(prefix, rows[list(r.ext_handles)])

    def _sweep_bin(self, rows, reqs, lp, ep):
        """[B, E]-batched sweep over one segment: prefix tuples pad by
        repeating their first handle (AND-idempotent), extension pads
        gather row 0 and are sliced off by the caller."""
        b = len(reqs)
        w = rows.shape[1]
        pidx = np.zeros((b, lp), np.int64)
        eidx = np.zeros((b, ep), np.int64)
        for i, r in enumerate(reqs):
            ph = r.prefix_handles
            pidx[i] = ph + (ph[0],) * (lp - len(ph))
            eidx[i, :len(r.ext_handles)] = r.ext_handles
        pr = rows[pidx.ravel()].reshape(b, lp, w)
        prefix = pr[:, 0]
        for j in range(1, lp):
            prefix = prefix & pr[:, j]
        out = np.empty((b, ep), np.int64)
        step = max(1, self.PASS_BYTES // max(ep * w * 4, 1))
        for lo in range(0, b, step):
            hi = min(lo + step, b)
            ex = rows[eidx[lo:hi].ravel()].reshape(hi - lo, ep, w)
            out[lo:hi] = tidlist.popcount32(
                ex & prefix[lo:hi, None, :]).sum(axis=2)
        return out


# E- and S-padding floor of the reference's kernel batches, kept so the
# tid payload billed to h2d_bytes has the same size in both engines.
E_PAD_FLOOR = 64


class TorchBackend(JoinBackend):
    """The kernel backend: per transaction segment a flush touches,
    ``bitmap_join_many_rows`` for its dense requests and
    ``gather_intersect_many_rows`` for its sparse ones — at most two
    launches per (flush, segment), so a one-segment arena (every batch
    mine) makes at most two per flush — each reading extension and
    prefix rows by index straight out of that segment's device mirror;
    the counts of a request's segments are summed. A tuple prefix goes
    to the dense kernel as a ``[B, L]`` index row, -1 past the tuple's
    end, and the kernel ANDs the tuple itself; a flush whose prefixes
    are all single rows passes ``[B]``. A sparse prefix's tids are
    searchsorted into the segment's tid window and rebased to it.

    A flush reads the mirrors of its requests' shard; on a sharded arena
    it names every row it reads (``needed``), so foreign rows are fetched
    into that shard's mirror and billed to ``d2d_bytes``.

    Each launch stages its int32 index array (``[pidx | eidx]`` dense,
    ``[eidx | lens | tids]`` sparse) in one host buffer, pinned on a CUDA
    arena, ships it with one ``non_blocking`` copy, and reads the counts
    back with one copy into a second pinned buffer; the buffers are
    reused and grown by the one dispatcher thread that owns this backend
    (each shard's dispatcher has a backend of its own). A launch covers
    the real batch: pad lanes carry -1 and read nothing, and no request
    is padded in. Only the sparse path's h2d bill keeps the reference's
    padded [B', S'] size (``E_PAD_FLOOR``), computed, not shipped.

    An arena without a mirror (backing "numpy") takes the host-gather
    path instead: the segment's rows are gathered on the host into the
    reference's padded ``[B', E', W_seg]`` shape (tuple prefixes ANDed
    there; pad requests and lanes name row 0, and their counts are
    sliced off), written straight into the same staging buffer, shipped
    with the one copy and swept by the gathered forms
    ``bitmap_join_many`` / ``gather_intersect_many``; the rows are billed
    to ``h2d_bytes`` as the reference bills them."""

    name = "torch"

    def __init__(self):
        self._stage: Optional[torch.Tensor] = None    # index staging
        self._counts: Optional[torch.Tensor] = None   # counts read-back

    def sweep_many(self, arena, requests):
        totals = [np.zeros(len(r.ext_handles), np.int64) for r in requests]
        # sub-batch per segment: full sweeps touch every segment, delta
        # sweeps only the fresh ones
        by_seg: Dict[int, List[int]] = {}
        for i, r in enumerate(requests):
            for g in r.segment_ids(arena):
                if arena.seg_words(g):
                    by_seg.setdefault(g, []).append(i)
        for g, idxs in sorted(by_seg.items()):
            dense = [i for i in idxs if not requests[i].is_sparse(arena)]
            sparse = [i for i in idxs if requests[i].is_sparse(arena)]
            for part, fn in ((dense, self._sweep_dense),
                             (sparse, self._sweep_sparse)):
                if not part:
                    continue
                # a view of the reused read-back buffer: consumed here,
                # before the next launch refills it
                counts = fn(arena, g, [requests[i] for i in part])
                for j, i in enumerate(part):
                    totals[i] += counts[j, :len(requests[i].ext_handles)]
        return totals

    @staticmethod
    def _host(buf, n, device):
        """The first ``n`` int32 slots of ``buf``, reallocated (pinned on
        a CUDA arena) when too small; returns (buffer, slots)."""
        if buf is None or buf.numel() < n:
            buf = torch.empty(pow2(n, lo=4096), dtype=torch.int32,
                              pin_memory=device.type == "cuda")
        return buf, buf[:n]

    def _staged(self, device, n):
        """A [n] int32 numpy view of the staging buffer to fill.

        The buffer is refilled only after the previous launch's counts
        were read back, which synchronises the stream (``_launch``): by
        then the non-blocking copy that read the buffer has completed.
        All launches of one flush share the buffer on that condition. A
        CPU test cannot show this race."""
        self._stage, host = self._host(self._stage, n, device)
        return host.numpy()

    def _launch(self, arena, seg, kernel, b, e, device, n, entry):
        """Ship the first ``n`` staged slots with one H→D copy, run
        ``entry(index_tensor)`` and read its [B, E] counts back through
        one D→H copy into pinned memory (then wait for the stream).
        Traced as a ``launch`` span naming the ``kernel``, its ``b``
        requests, their widest ``e`` extensions and segment ``seg``."""
        tr = arena.tracer
        t0 = tr.now() if tr is not None else 0.0
        idx = self._stage[:n].to(device, non_blocking=True)
        counts = entry(idx)
        self._counts, out = self._host(self._counts, counts.numel(), device)
        out = out.view(counts.shape)
        out.copy_(counts, non_blocking=True)
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        if tr is not None:
            tr.span("launch", t0, cat="flush",
                    args={"kernel": kernel, "B": b, "E": e, "segment": seg})
        return out.numpy()

    @staticmethod
    def _fill_eidx(eidx, requests):
        eidx.fill(-1)
        for i, r in enumerate(requests):
            eidx[i, :len(r.ext_handles)] = r.ext_handles

    @staticmethod
    def _fill_pidx(pidx, requests):
        """Prefix tuples into [B, L] (-1 past each tuple's end)."""
        pidx.fill(-1)
        for i, r in enumerate(requests):
            pidx[i, :len(r.prefix_handles)] = r.prefix_handles

    @staticmethod
    def _gather_into(rows, handles, out):
        """Host rows of ``handles`` into the staged uint32 view ``out``;
        a pad handle of -1 reads as row 0 (``take``'s clip mode)."""
        np.take(rows, handles, axis=0, mode="clip",
                out=out.view(np.uint32).reshape(len(handles), -1))

    @classmethod
    def _gather_exts(cls, rows, requests, bp, ep, out):
        """The host rows of every request's extensions, padded to
        [bp, ep], into the staged view ``out``; pad counts are sliced
        off."""
        eidx = np.empty((bp, ep), np.int64)
        cls._fill_eidx(eidx, requests)
        cls._gather_into(rows, eidx.ravel(), out)

    @staticmethod
    def _mirror(arena, seg, requests):
        """The flush's shard and its mirror of segment ``seg`` (None
        without one), synced with the rows the requests read."""
        shard = requests[0].shard
        needed = ([h for r in requests for h in r.rows]
                  if arena.n_shards > 1 else None)
        return shard, arena.device_rows(shard, needed=needed, segment=seg)

    def _sweep_dense(self, arena, seg, requests):
        b = len(requests)
        e = max(len(r.ext_handles) for r in requests)
        lmax = max(len(r.prefix_handles) for r in requests)
        shard, mirror = self._mirror(arena, seg, requests)
        if mirror is None:
            return self._sweep_dense_gathered(arena, seg, requests, e, lmax,
                                              arena.shard_device(shard))
        np_ = b * lmax
        host = self._staged(mirror.device, np_ + b * e)
        self._fill_pidx(host[:np_].reshape(b, lmax), requests)
        self._fill_eidx(host[np_:].reshape(b, e), requests)
        # single-row prefixes keep the [B] index of a batch mine
        shape = (b, lmax) if lmax > 1 else (b,)
        return self._launch(
            arena, seg, "bitmap_join_many", b, e, mirror.device, np_ + b * e,
            lambda idx: bitmap_join_many_rows(
                mirror, idx[:np_].view(shape), mirror, idx[np_:].view(b, e),
                arena.seg_words(seg)))

    def _sweep_dense_gathered(self, arena, seg, requests, e, lmax, device):
        """Host-gather dense sweep of one segment: ``[prefixes [B', W] |
        exts [B', E', W]]`` staged as one array, each tuple prefix ANDed
        on the host first, billed ``(B' + B'·E')·W·4`` bytes."""
        b, w = len(requests), arena.seg_words(seg)
        bp, ep = pow2(b), pow2(e, lo=E_PAD_FLOOR)
        rows = arena.seg_view(seg)
        pidx = np.zeros((bp, lmax), np.int64)
        for i, r in enumerate(requests):
            ph = r.prefix_handles
            # pad by repeating the first handle: AND-idempotent
            pidx[i] = ph + (ph[0],) * (lmax - len(ph))
        n = bp * w + bp * ep * w
        host = self._staged(device, n)
        self._gather_into(rows, pidx[:, 0], host[:bp * w])
        prefixes = host[:bp * w].view(np.uint32).reshape(bp, w)
        for j in range(1, lmax):
            prefixes &= rows[pidx[:, j]]
        self._gather_exts(rows, requests, bp, ep, host[bp * w:])
        arena.count_h2d((bp + bp * ep) * w * 4)
        return self._launch(
            arena, seg, "bitmap_join_many", b, e, device, n,
            lambda x: bitmap_join_many(x[:bp * w].view(bp, w),
                                       x[bp * w:].view(bp, ep, w)))

    def _sweep_sparse(self, arena, seg, requests):
        """Sparse sub-batch of one segment: prefixes are tid/diffset
        payloads cut to the segment's tid window and rebased to it,
        shipped host→device per launch (billed at the reference's padded
        [B', S'] int32 array — sparse rows have no mirror payload)."""
        b = len(requests)
        e = max(len(r.ext_handles) for r in requests)
        lo, hi = arena.seg_tid_range(seg)
        payloads = []
        for r in requests:
            tids = arena.tids_of(r.prefix_handle)
            i0, i1 = np.searchsorted(tids, [lo, hi])
            payloads.append(tids[i0:i1].astype(np.int64) - lo)
        s = max(1, max(len(t) for t in payloads))
        shard, mirror = self._mirror(arena, seg, requests)
        if mirror is None:
            return self._sweep_sparse_gathered(arena, seg, requests,
                                               payloads, e, s,
                                               arena.shard_device(shard))
        arena.count_h2d(pow2(b) * pow2(s, lo=E_PAD_FLOOR) * 4)
        n = b * e + b + b * s
        host = self._staged(mirror.device, n)
        self._fill_eidx(host[:b * e].reshape(b, e), requests)
        host[b * e:b * e + b] = [len(t) for t in payloads]
        tids = host[b * e + b:].reshape(b, s)
        tids.fill(-1)
        for i, t in enumerate(payloads):
            tids[i, :len(t)] = t
        return self._launch(
            arena, seg, "gather_intersect_many", b, e, mirror.device, n,
            lambda idx: gather_intersect_many_rows(
                idx[b * e + b:].view(b, s), idx[b * e:b * e + b], mirror,
                idx[:b * e].view(b, e), arena.seg_words(seg)))

    def _sweep_sparse_gathered(self, arena, seg, requests, payloads, e, s,
                               device):
        """Host-gather sparse sweep of one segment: ``[tids [B', S'] |
        exts [B', E', W]]`` staged as one array (tids padded with -1),
        billed ``(B'·E'·W + B'·S')·4`` bytes."""
        b, w = len(requests), arena.seg_words(seg)
        bp, ep, sp = pow2(b), pow2(e, lo=E_PAD_FLOOR), pow2(s, lo=E_PAD_FLOOR)
        n = bp * sp + bp * ep * w
        host = self._staged(device, n)
        tids = host[:bp * sp].reshape(bp, sp)
        tids.fill(-1)
        for i, t in enumerate(payloads):
            tids[i, :len(t)] = t
        self._gather_exts(arena.seg_view(seg), requests, bp, ep,
                          host[bp * sp:])
        arena.count_h2d((bp * ep * w + bp * sp) * 4)
        return self._launch(
            arena, seg, "gather_intersect_many", b, e, device, n,
            lambda x: gather_intersect_many(x[:bp * sp].view(bp, sp),
                                            x[bp * sp:].view(bp, ep, w)))


_REGISTRY: Dict[str, Callable[[], JoinBackend]] = {
    "numpy": NumpyBackend,
    "torch": TorchBackend,
}


def get_backend(name: str) -> JoinBackend:
    """A new backend by name. Each call builds its own instance: a
    ``TorchBackend`` owns staging buffers that one dispatcher thread
    reuses between launches, so two dispatchers must not share one."""
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown join backend {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def available_backends(device: "torch.device | str | None" = None
                       ) -> List[str]:
    """Backends that can execute here: ``numpy`` always, and the kernel
    backend ``torch`` when a CUDA device is present or the caller asks
    for the CPU (where it runs the kernels' plain versions)."""
    names = ["numpy"]
    if (device is not None and torch.device(device).type == "cpu") or \
            torch.cuda.is_available():
        names.append("torch")
    return names


def resolve_backend(spec: str = "auto") -> JoinBackend:
    """"auto" is the kernel backend, which runs on whatever device the
    arena lives on; "numpy" runs only when named."""
    return get_backend("torch" if spec == "auto" else spec)


class SweepDispatcher:
    """Coalesces many workers' sweep requests into batched launches.

    Workers call :meth:`sweep` (or :meth:`submit` + ``future.result()``)
    and block; the dedicated dispatcher thread gathers pending requests
    and flushes a batch when either

      * ``min(max_batch, n_clients)`` requests are pending — since
        ``sweep`` blocks its caller, pending requests count currently
        blocked clients, so once every client is waiting no further
        request can arrive and waiting longer is pure latency; or
      * ``flush_us`` elapsed since the flush started forming — bounding
        the latency a lone straggler pays when other workers are busy
        with non-sweep work; ``query_flush_us`` once a priority (query)
        request is pending.

    Errors from the backend resolve every future in the flight batch,
    so task bodies re-raise through the scheduler's normal task-error
    machinery. ``batch_occupancy`` (requests per flush) shows whether
    batching actually happened.

    ``shard`` is the arena shard this dispatcher serves: it stamps every
    request it accepts, so its backend reads that shard's mirrors and
    books foreign rows to it. A mesh runs one dispatcher, with a backend
    of its own, per shard; ``n_clients`` is then the workers pinned to
    this shard.

    ``cluster`` (a multi-host context, ``repro_torch.core.cluster``)
    makes every flush two-phase: partial counts over this arena's owned
    words, then ``cluster.reduce_flush`` adds the peers' partials for the
    same descriptors. One reduction per flush, so the cross-host traffic
    amortizes as the launches do.
    """

    def __init__(self, arena: BitmapArena, backend: JoinBackend,
                 n_clients: int, max_batch: int = MAX_BATCH,
                 flush_us: float = FLUSH_US, shard: int = 0,
                 query_flush_us: float = QUERY_FLUSH_US,
                 cluster=None, tracer=None, trace_pid: int = 0):
        self.arena = arena
        self.backend = backend
        self.cluster = cluster
        # observability: None = off; spans record flush formation on
        # the dispatcher lane and blocking sweeps on the caller's lane
        self.tracer = tracer
        self.trace_pid = trace_pid
        self.n_clients = max(1, n_clients)
        self.max_batch = max(1, max_batch)
        self.flush_s = max(0.0, flush_us) * 1e-6
        self.query_flush_s = max(0.0, query_flush_us) * 1e-6
        self.shard = shard
        self.sweep_s = 0.0            # backend busy time (s)
        self._pending: List[SweepRequest] = []
        self._n_priority = 0          # priority requests in _pending
        self._cv = threading.Condition()
        self._stop = False
        self.flushes = 0
        self.requests = 0
        self.query_requests = 0       # priority (serving) requests seen
        # dispatcher-thread flushes only (sweep_local's and sweep_bits'
        # inline sweeps bill themselves as flushes but never coalesce
        # with anything)
        self.queue_flushes = 0
        self.queue_requests = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"sweep-dispatcher-{shard}")
        self._thread.start()

    # ------------------------------------------------------------ client --
    def _make_requests(self, sweeps: Sequence[Tuple],
                       segments: Optional[Sequence[int]],
                       priority: bool = False,
                       desc: Optional[Tuple[int, ...]] = None
                       ) -> List[SweepRequest]:
        segs = tuple(segments) if segments is not None else None
        return [SweepRequest(
                    (tuple(int(h) for h in p) if isinstance(p, tuple)
                     else int(p)),
                    tuple(e), shard=self.shard, segments=segs,
                    priority=priority, desc=desc)
                for p, e in sweeps]

    def _submit(self, sweeps: Sequence[Tuple],
                segments: Optional[Sequence[int]], priority: bool = False,
                desc: Optional[Tuple[int, ...]] = None
                ) -> List[SweepRequest]:
        reqs = self._make_requests(sweeps, segments, priority, desc)
        self._enqueue(reqs, priority)
        return reqs

    def _enqueue(self, reqs: List[SweepRequest], priority: bool) -> None:
        with self._cv:
            if self._stop:
                raise RuntimeError("dispatcher is stopped")
            if priority:
                # the burst jumps the queue, its own order kept
                self._pending[:0] = reqs
                self._n_priority += len(reqs)
                self.query_requests += len(reqs)
            else:
                self._pending.extend(reqs)
            self._cv.notify_all()

    def submit(self, prefix_handle, ext_handles: Sequence[int],
               segments: Optional[Sequence[int]] = None,
               priority: bool = False,
               desc: Optional[Tuple[int, ...]] = None) -> Future:
        """Enqueue one sweep; ``prefix_handle`` is a handle or a tuple of
        handles, ``segments`` restricts it to a segment subset, ``desc``
        is the prefix itemset a cluster peer evaluates."""
        return self._submit([(prefix_handle, ext_handles)], segments,
                            priority, desc)[0].future

    def submit_many(self, sweeps: Sequence[Tuple],
                    segments: Optional[Sequence[int]] = None,
                    priority: bool = False) -> List[Future]:
        """Enqueue a burst of ``(prefix, ext_handles)`` sweeps under one
        lock acquisition and one wakeup — the streaming delta path's
        coalescing entry point. ``priority=True`` marks the burst as
        query-class: it goes to the front of the pending queue (order
        kept within the burst) and shortens the straggler wait to
        ``query_flush_us``."""
        return [r.future for r in self._submit(sweeps, segments, priority)]

    def sweep_local(self, sweeps: Sequence[Tuple],
                    segments: Optional[Sequence[int]] = None
                    ) -> List[np.ndarray]:
        """Execute a burst of ``(prefix, ext_handles)`` sweeps and return
        counts arrays aligned with ``sweeps``.

        A host-parallel backend runs the burst on the calling thread (its
        ufunc passes release the GIL, so workers' bursts run in
        parallel) and bills it as one flush of ``len(sweeps)`` requests.
        The kernel backend goes through :meth:`submit_many`, so only the
        dispatcher thread touches the device and the burst coalesces into
        its launches."""
        if not sweeps:
            return []
        if not self.backend.host_parallel:
            tr = self.tracer
            if tr is None:
                return [f.result()
                        for f in self.submit_many(sweeps, segments=segments)]
            t0 = tr.now()
            reqs = self._submit(sweeps, segments)
            results = [r.future.result() for r in reqs]
            # the caller's blocked time, as ``sweep`` records it; the
            # burst's last request names the flush that ended the wait
            tr.span("sweep", t0, cat="sweep",
                    args={"requests": len(reqs), "flush": reqs[-1].flush,
                          "queued_s": sum(r.flush_t0 - t0 for r in reqs)
                          / len(reqs)})
            return results
        reqs = self._make_requests(sweeps, segments)
        with self._cv:
            if self._stop:
                raise RuntimeError("dispatcher is stopped")
            self.flushes += 1
            self.requests += len(reqs)
        t0 = time.perf_counter()
        results = self.backend.sweep_many(self.arena, reqs)
        with self._cv:
            self.sweep_s += time.perf_counter() - t0
        if self.cluster is not None:
            results = self.cluster.reduce_flush(reqs, results)
        if self.tracer is not None:
            # inline burst: the flush span lands on the calling worker's
            # lane (that is where the time went)
            self.tracer.span("flush", t0, cat="flush",
                             args=self._flush_args(
                                 reqs, self.tracer.serial(), inline=True))
        return results

    def sweep(self, prefix_handle, ext_handles: Sequence[int],
              segments: Optional[Sequence[int]] = None,
              desc: Optional[Tuple[int, ...]] = None) -> np.ndarray:
        """Blocking convenience: enqueue and wait for the counts."""
        tr = self.tracer
        if tr is None:
            return self.submit(prefix_handle, ext_handles,
                               segments=segments, desc=desc).result()
        t0 = tr.now()
        req = self._submit([(prefix_handle, ext_handles)], segments,
                           desc=desc)[0]
        counts = req.future.result()
        # caller-side wait: nests inside the worker's task span; it
        # names the flush that answered and the wait before that flush
        tr.span("sweep", t0, cat="sweep",
                args={"ext": len(ext_handles), "flush": req.flush,
                      "queued_s": req.flush_t0 - t0})
        return counts

    def sweep_bits(self, prefix_handle: int, ext_handles: Sequence[int],
                   desc: Optional[Tuple[int, ...]] = None
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Depth-first class sweep over every segment: ``(counts,
        bits)``, where ``bits`` is the [E, S] payload∩ext matrix of the
        same gather the counts came from (sparse prefixes on
        host-parallel backends; None otherwise).

        Host-parallel backends run inline on the calling thread: one
        class sweep is one vectorized pass, cheaper than the enqueue →
        wakeup → future round trip. The kernel backend keeps the batched
        queue, so only the dispatcher thread touches the device, and
        returns no bits. An inline sweep is billed as a 1-request flush,
        so ``flushes × occupancy == requests`` stays exact."""
        if not self.backend.host_parallel:
            return self.sweep(prefix_handle, ext_handles, desc=desc), None
        req = self._make_requests([(prefix_handle, ext_handles)], None,
                                  desc=desc)[0]
        with self._cv:
            if self._stop:
                raise RuntimeError("dispatcher is stopped")
            self.flushes += 1
            self.requests += 1
        sparse = req.is_sparse(self.arena)
        t0 = time.perf_counter()
        if sparse:
            if self.arena.n_shards > 1:
                # the bits path reads the rows outside sweep_many
                self.arena.note_access(self.shard, req.rows)
            out = self.backend.sweep_sparse_bits(self.arena, req)
        else:
            out = self.backend.sweep_many(self.arena, [req])[0], None
        with self._cv:
            self.sweep_s += time.perf_counter() - t0
        if self.cluster is not None:
            # cluster runs pin the bitmap representation: never sparse
            out = self.cluster.reduce_flush([req], [out[0]])[0], None
        if self.tracer is not None:
            self.tracer.span("sweep", t0, cat="sweep",
                             args={"ext": len(req.ext_handles),
                                   "sparse": sparse})
        return out

    @property
    def batch_occupancy(self) -> float:
        return self.requests / self.flushes if self.flushes else 0.0

    def stats(self) -> Dict[str, float]:
        """This dispatcher's gauges on the ``repro_torch.obs.schema``
        device schema."""
        return obs_schema.device_stats(
            {"device": self.shard, "flushes": self.flushes,
             "sweep_requests": self.requests,
             "query_requests": self.query_requests,
             "queue_flushes": self.queue_flushes,
             "queue_requests": self.queue_requests,
             "sweep_s": self.sweep_s})

    def _flush_args(self, batch: Sequence[SweepRequest], flush: int,
                    inline: bool = False) -> Dict[str, float]:
        """Span payload for one flush: its id, the requests and rows it
        carried, the dense/sparse split and the query count. Only runs
        when a tracer is attached."""
        rows = sum(len(r.prefix_handles) + len(r.ext_handles)
                   for r in batch)
        sparse = sum(1 for r in batch if r.is_sparse(self.arena))
        return {"flush": flush, "requests": len(batch), "rows": rows,
                "sparse": sparse, "dense": len(batch) - sparse,
                "queries": sum(1 for r in batch if r.priority),
                "inline": inline}

    # -------------------------------------------------------------- loop --
    def _loop(self):
        tr = self.tracer
        if tr is not None:
            tr.set_lane(f"dispatcher-{self.shard}",
                        sort_index=1000 + self.shard, pid=self.trace_pid)
        full = min(self.max_batch, self.n_clients)
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait()
                if not self._pending and self._stop:
                    return
                if len(self._pending) < full and not self._stop:
                    deadline = time.monotonic() + self.flush_s
                    while len(self._pending) < full and not self._stop:
                        # a pending query caps the straggler wait; the
                        # cap re-applies on every pass, so a query that
                        # arrives mid-wait also shortens the window
                        if self._n_priority:
                            deadline = min(deadline, time.monotonic()
                                           + self.query_flush_s)
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        self._cv.wait(timeout=left)
                batch = self._pending[:self.max_batch]
                del self._pending[:self.max_batch]
                self._n_priority -= sum(1 for r in batch if r.priority)
                self.flushes += 1
                self.requests += len(batch)
                self.queue_flushes += 1
                self.queue_requests += len(batch)
            try:
                t0 = time.perf_counter()
                if tr is not None:
                    fid = tr.serial()
                    for r in batch:      # read by the waiting callers
                        r.flush, r.flush_t0 = fid, t0
                results = self.backend.sweep_many(self.arena, batch)
                t1 = time.perf_counter()
                with self._cv:
                    self.sweep_s += t1 - t0
                if self.cluster is not None:
                    results = self.cluster.reduce_flush(batch, results)
                    if tr is not None:
                        # the cross-host reduction tail of this flush
                        tr.span("net-flush", t1, cat="net",
                                args={"requests": len(batch)})
                if tr is not None:
                    tr.span("flush", t0, cat="flush",
                            args=self._flush_args(batch, fid))
            except BaseException as e:  # noqa: BLE001 - resolve futures:
                for r in batch:         # a swallowed error would deadlock
                    r.future.set_exception(e)   # every blocked worker
            else:
                for r, counts in zip(batch, results):
                    r.future.set_result(counts)

    def stop(self):
        """Drain pending requests, then join the dispatcher thread."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=10)
        with self._cv:                  # only non-empty if the thread died
            leftover, self._pending = self._pending, []
        for r in leftover:
            r.future.set_exception(RuntimeError("dispatcher stopped"))
