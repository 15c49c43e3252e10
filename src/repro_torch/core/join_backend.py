"""Batched join backends + the sweep dispatcher.

A *bucket sweep* is the paper's per-task TID join restructured at bucket
granularity: one (k-1)-prefix bitmap against the bucket's E extension
bitmaps, producing E support counts in one call. Two pieces carry it:

  ``BitmapArena`` (repro_torch.core.tidlist)  every bitmap lives in one
      refcounted row store with integer handles; its device mirror is
      synced incrementally, so repeated sweeps cost ~one initial upload.
  ``SweepDispatcher``  workers enqueue handle-based ``SweepRequest``s
      and block on a future; one dispatcher thread coalesces pending
      requests into a padded batch and launches one kernel per
      representation for all of them. Only the dispatcher thread touches
      the device. Depth-first class sweeps (``sweep_bits``) take the
      same queue on the kernel backend and run inline on the calling
      worker on the host backend.

Backends implement the same batched API:

  numpy   per-request ``tidlist.support_counts`` over zero-copy arena
          row views — GIL-released ufunc passes on the host. It runs
          only when asked for by name.
  torch   the kernel backend: dense prefixes go to ``bitmap_join_many``
          and sparse (tid-list/diffset) prefixes to
          ``gather_intersect_many``, whose indexed entries read prefix and
          extension rows from the arena's mirror by handle. An arena with
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


@dataclass
class SweepRequest:
    """One bucket sweep, by handle: counts[i] = |row(prefix) ∧ row(ext_i)|.

    When ``prefix_handle`` is a SPARSE arena row (tid-list or diffset),
    the backend runs the gather-intersect path and the counts are
    ``|payload ∩ ext_i|`` over the raw sparse payload — for a tid-list
    that IS the support, for a diffset it is the subtrahend. One flush
    may mix representations; the backend partitions per launch."""
    prefix_handle: int
    ext_handles: Tuple[int, ...]
    future: Future = field(default_factory=Future)

    def is_sparse(self, arena: BitmapArena) -> bool:
        """True when the prefix row is a tid-list/diffset."""
        return arena.rep_of(self.prefix_handle) != tidlist.REP_BITMAP


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
    batched: a flush's dense requests are binned by padded E and each
    bin executes as a few wide numpy passes (index gather → AND → fused
    popcount); sparse requests gather one word per tid."""

    name = "numpy"
    host_parallel = True
    # bound on a bin pass's [B, E, W] AND temporary (slices B)
    PASS_BYTES = 4 << 20

    def sweep_many(self, arena, requests):
        totals: List[np.ndarray] = [None] * len(requests)
        dense: List[int] = []
        for i, r in enumerate(requests):
            if r.is_sparse(arena):
                totals[i] = self.sweep_sparse_bits(arena, r)[0]
            else:
                dense.append(i)
        rows = arena.rows_view()
        if len(dense) == 1:
            i = dense[0]
            totals[i] = self._sweep_one(rows, requests[i])
        elif dense:
            # bin by padded E so one fancy-index gather serves the bin
            bins: Dict[int, List[int]] = {}
            for i in dense:
                bins.setdefault(pow2(len(requests[i].ext_handles)),
                                []).append(i)
            for ep, bi in sorted(bins.items()):
                counts = self._sweep_bin(rows, [requests[i] for i in bi],
                                         ep)
                for j, i in enumerate(bi):
                    totals[i] = counts[j, :len(requests[i].ext_handles)]
        return totals

    @staticmethod
    def sweep_sparse_bits(arena, r):
        """Sparse-prefix sweep: gather the ext word at every prefix tid
        and test one bit — an [E, S] bit matrix, no [E, W] dense gather
        copy. Returns ``(counts, bits)``, the bit columns aligned with
        the prefix's sorted payload: a depth-first class task counts
        with it and carves its children from it without gathering
        again."""
        bits = arena.gather_bits_rows(arena.tids_of(r.prefix_handle),
                                      r.ext_handles)
        return bits.sum(axis=1, dtype=np.int64), bits

    @staticmethod
    def _sweep_one(rows, r):
        return tidlist.support_counts(rows[r.prefix_handle],
                                      rows[list(r.ext_handles)])

    def _sweep_bin(self, rows, reqs, ep):
        """[B, E]-batched sweep: extension pads gather row 0 and are
        sliced off by the caller."""
        b = len(reqs)
        w = rows.shape[1]
        eidx = np.zeros((b, ep), np.int64)
        for i, r in enumerate(reqs):
            eidx[i, :len(r.ext_handles)] = r.ext_handles
        prefix = rows[[r.prefix_handle for r in reqs]]
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
    """The kernel backend: ``bitmap_join_many_rows`` for the dense
    requests of a flush and ``gather_intersect_many_rows`` for the sparse
    ones — at most two launches per flush — both reading extension and
    prefix rows by index straight out of the arena's device mirror.

    Each launch stages its int32 index array (``[pidx | eidx]`` dense,
    ``[eidx | lens | tids]`` sparse) in one host buffer, pinned on a CUDA
    arena, ships it with one ``non_blocking`` copy, and reads the counts
    back with one copy into a second pinned buffer; the buffers are
    reused and grown by the dispatcher thread. A launch covers the real
    batch: pad lanes carry -1 and read nothing, and no request is padded
    in. Only the sparse path's h2d bill keeps the reference's padded
    [B', S'] size (``E_PAD_FLOOR``), computed, not shipped.

    An arena without a mirror (backing "numpy") takes the host-gather
    path instead: the batch's rows are gathered on the host into the
    reference's padded ``[B', E', W]`` shape (pad requests and lanes
    name row 0, and their counts are sliced off), written straight into
    the same staging buffer, shipped with the one copy and swept by the
    gathered forms ``bitmap_join_many`` / ``gather_intersect_many``; the
    rows are billed to ``h2d_bytes`` as the reference bills them."""

    name = "torch"

    def __init__(self):
        self._stage: Optional[torch.Tensor] = None    # index staging
        self._counts: Optional[torch.Tensor] = None   # counts read-back

    def sweep_many(self, arena, requests):
        totals = [np.zeros(len(r.ext_handles), np.int64) for r in requests]
        if not arena.n_words:
            return totals
        dense = [i for i, r in enumerate(requests) if not r.is_sparse(arena)]
        sparse = [i for i, r in enumerate(requests) if r.is_sparse(arena)]
        for part, fn in ((dense, self._sweep_dense),
                         (sparse, self._sweep_sparse)):
            if not part:
                continue
            # a view of the reused read-back buffer: consumed here,
            # before the next launch refills it
            counts = fn(arena, [requests[i] for i in part])
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
        The dense and sparse launches of one flush share the buffer on
        that condition. A CPU test cannot show this race."""
        self._stage, host = self._host(self._stage, n, device)
        return host.numpy()

    def _launch(self, device, n, entry):
        """Ship the first ``n`` staged slots with one H→D copy, run
        ``entry(index_tensor)`` and read its [B, E] counts back through
        one D→H copy into pinned memory (then wait for the stream)."""
        idx = self._stage[:n].to(device, non_blocking=True)
        counts = entry(idx)
        self._counts, out = self._host(self._counts, counts.numel(), device)
        out = out.view(counts.shape)
        out.copy_(counts, non_blocking=True)
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        return out.numpy()

    @staticmethod
    def _fill_eidx(eidx, requests):
        eidx.fill(-1)
        for i, r in enumerate(requests):
            eidx[i, :len(r.ext_handles)] = r.ext_handles

    @classmethod
    def _gather_exts(cls, arena, requests, bp, ep, out):
        """The host rows of every request's extensions, padded to
        [bp, ep], into the staged view ``out``. Pad lanes carry -1,
        which ``take``'s clip mode reads as row 0; their counts are
        sliced off."""
        eidx = np.empty((bp, ep), np.int64)
        cls._fill_eidx(eidx, requests)
        cls._gather_into(arena, eidx.ravel(), out)

    @staticmethod
    def _gather_into(arena, handles, out):
        """Host rows of ``handles`` into the staged uint32 view ``out``."""
        np.take(arena.rows_view(), handles, axis=0, mode="clip",
                out=out.view(np.uint32).reshape(len(handles), -1))

    def _sweep_dense(self, arena, requests):
        b = len(requests)
        e = max(len(r.ext_handles) for r in requests)
        mirror = arena.device_rows()
        if mirror is None:
            return self._sweep_dense_gathered(arena, requests, e)
        host = self._staged(mirror.device, b + b * e)
        host[:b] = [r.prefix_handle for r in requests]
        self._fill_eidx(host[b:].reshape(b, e), requests)
        return self._launch(mirror.device, b + b * e, lambda idx: (
            bitmap_join_many_rows(mirror, idx[:b], mirror,
                                  idx[b:].view(b, e), arena.n_words)))

    def _sweep_dense_gathered(self, arena, requests, e):
        """Host-gather dense sweep: ``[prefixes [B', W] | exts [B', E',
        W]]`` staged as one array, billed ``(B' + B'·E')·W·4`` bytes."""
        b, w = len(requests), arena.n_words
        bp, ep = pow2(b), pow2(e, lo=E_PAD_FLOOR)
        pidx = np.zeros(bp, np.int64)
        pidx[:b] = [r.prefix_handle for r in requests]
        n = bp * w + bp * ep * w
        host = self._staged(arena.device, n)
        self._gather_into(arena, pidx, host[:bp * w])
        self._gather_exts(arena, requests, bp, ep, host[bp * w:])
        arena.count_h2d((bp + bp * ep) * w * 4)
        return self._launch(arena.device, n, lambda x: bitmap_join_many(
            x[:bp * w].view(bp, w), x[bp * w:].view(bp, ep, w)))

    def _sweep_sparse(self, arena, requests):
        """Sparse sub-batch: prefixes are tid/diffset payloads, shipped
        host→device per launch (billed at the reference's padded [B', S']
        int32 array — sparse rows have no mirror payload)."""
        b = len(requests)
        e = max(len(r.ext_handles) for r in requests)
        payloads = [arena.tids_of(r.prefix_handle) for r in requests]
        s = max(1, max(len(t) for t in payloads))
        mirror = arena.device_rows()
        if mirror is None:
            return self._sweep_sparse_gathered(arena, requests, payloads,
                                               e, s)
        arena.count_h2d(pow2(b) * pow2(s, lo=E_PAD_FLOOR) * 4)
        n = b * e + b + b * s
        host = self._staged(mirror.device, n)
        self._fill_eidx(host[:b * e].reshape(b, e), requests)
        host[b * e:b * e + b] = [len(t) for t in payloads]
        tids = host[b * e + b:].reshape(b, s)
        tids.fill(-1)
        for i, t in enumerate(payloads):
            tids[i, :len(t)] = t
        return self._launch(mirror.device, n, lambda idx: (
            gather_intersect_many_rows(
                idx[b * e + b:].view(b, s), idx[b * e:b * e + b], mirror,
                idx[:b * e].view(b, e), arena.n_words)))

    def _sweep_sparse_gathered(self, arena, requests, payloads, e, s):
        """Host-gather sparse sweep: ``[tids [B', S'] | exts [B', E',
        W]]`` staged as one array (tids padded with -1), billed
        ``(B'·E'·W + B'·S')·4`` bytes."""
        b, w = len(requests), arena.n_words
        bp, ep, sp = pow2(b), pow2(e, lo=E_PAD_FLOOR), pow2(s, lo=E_PAD_FLOOR)
        n = bp * sp + bp * ep * w
        host = self._staged(arena.device, n)
        tids = host[:bp * sp].reshape(bp, sp)
        tids.fill(-1)
        for i, t in enumerate(payloads):
            tids[i, :len(t)] = t
        self._gather_exts(arena, requests, bp, ep, host[bp * sp:])
        arena.count_h2d((bp * ep * w + bp * sp) * 4)
        return self._launch(arena.device, n, lambda x: gather_intersect_many(
            x[:bp * sp].view(bp, sp), x[bp * sp:].view(bp, ep, w)))


_REGISTRY: Dict[str, Callable[[], JoinBackend]] = {
    "numpy": NumpyBackend,
    "torch": TorchBackend,
}


def get_backend(name: str) -> JoinBackend:
    """A new backend by name. Each call builds its own instance: a
    ``TorchBackend`` owns staging buffers that one dispatcher thread
    reuses between launches, so two runs must not share one."""
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
        with non-sweep work.

    Errors from the backend resolve every future in the flight batch,
    so task bodies re-raise through the scheduler's normal task-error
    machinery. ``batch_occupancy`` (requests per flush) shows whether
    batching actually happened.
    """

    def __init__(self, arena: BitmapArena, backend: JoinBackend,
                 n_clients: int, max_batch: int = MAX_BATCH,
                 flush_us: float = FLUSH_US, shard: int = 0,
                 tracer=None, trace_pid: int = 0):
        self.arena = arena
        self.backend = backend
        # observability: None = off; spans record flush formation on
        # the dispatcher lane and blocking sweeps on the caller's lane
        self.tracer = tracer
        self.trace_pid = trace_pid
        self.n_clients = max(1, n_clients)
        self.max_batch = max(1, max_batch)
        self.flush_s = max(0.0, flush_us) * 1e-6
        self.shard = shard
        self.sweep_s = 0.0            # backend busy time (s)
        self._pending: List[SweepRequest] = []
        self._cv = threading.Condition()
        self._stop = False
        self.flushes = 0
        self.requests = 0
        # dispatcher-thread flushes only (sweep_bits' inline sweeps bill
        # themselves as flushes but never coalesce with anything)
        self.queue_flushes = 0
        self.queue_requests = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"sweep-dispatcher-{shard}")
        self._thread.start()

    # ------------------------------------------------------------ client --
    def submit(self, prefix_handle: int,
               ext_handles: Sequence[int]) -> Future:
        req = SweepRequest(int(prefix_handle), tuple(ext_handles))
        with self._cv:
            if self._stop:
                raise RuntimeError("dispatcher is stopped")
            self._pending.append(req)
            self._cv.notify_all()
        return req.future

    def sweep(self, prefix_handle: int,
              ext_handles: Sequence[int]) -> np.ndarray:
        """Blocking convenience: enqueue and wait for the counts."""
        tr = self.tracer
        if tr is None:
            return self.submit(prefix_handle, ext_handles).result()
        t0 = tr.now()
        counts = self.submit(prefix_handle, ext_handles).result()
        # caller-side wait: nests inside the worker's task span
        tr.span("sweep", t0, cat="sweep", args={"ext": len(ext_handles)})
        return counts

    def sweep_bits(self, prefix_handle: int, ext_handles: Sequence[int]
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Depth-first class sweep: ``(counts, bits)``, where ``bits`` is
        the [E, S] payload∩ext matrix of the same gather the counts came
        from (sparse prefixes on host-parallel backends; None otherwise).

        Host-parallel backends run inline on the calling thread: one
        class sweep is one vectorized pass, cheaper than the enqueue →
        wakeup → future round trip. The kernel backend keeps the batched
        queue, so only the dispatcher thread touches the device, and
        returns no bits. An inline sweep is billed as a 1-request flush,
        so ``flushes × occupancy == requests`` stays exact."""
        if not self.backend.host_parallel:
            return self.sweep(prefix_handle, ext_handles), None
        req = SweepRequest(int(prefix_handle), tuple(ext_handles))
        with self._cv:
            if self._stop:
                raise RuntimeError("dispatcher is stopped")
            self.flushes += 1
            self.requests += 1
        sparse = req.is_sparse(self.arena)
        t0 = time.perf_counter()
        if sparse:
            out = self.backend.sweep_sparse_bits(self.arena, req)
        else:
            out = self.backend.sweep_many(self.arena, [req])[0], None
        with self._cv:
            self.sweep_s += time.perf_counter() - t0
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
             "queue_flushes": self.queue_flushes,
             "queue_requests": self.queue_requests,
             "sweep_s": self.sweep_s})

    def _flush_args(self, batch: Sequence[SweepRequest]
                    ) -> Dict[str, float]:
        """Span payload for one flush: occupancy, an upper-bound byte
        figure (rows × full arena width) and the dense/sparse split.
        Only runs when a tracer is attached."""
        arena = self.arena
        rows = sum(1 + len(r.ext_handles) for r in batch)
        sparse = sum(1 for r in batch if r.is_sparse(arena))
        return {"requests": len(batch), "occupancy": len(batch),
                "rows": rows, "batch_bytes": rows * arena.n_words * 4,
                "sparse": sparse, "dense": len(batch) - sparse}

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
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        self._cv.wait(timeout=left)
                batch = self._pending[:self.max_batch]
                del self._pending[:self.max_batch]
                self.flushes += 1
                self.requests += len(batch)
                self.queue_flushes += 1
                self.queue_requests += len(batch)
            try:
                t0 = time.perf_counter()
                results = self.backend.sweep_many(self.arena, batch)
                with self._cv:
                    self.sweep_s += time.perf_counter() - t0
                if tr is not None:
                    tr.span("flush", t0, cat="flush",
                            args=self._flush_args(batch))
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
