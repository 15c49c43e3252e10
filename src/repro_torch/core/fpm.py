"""Apriori FPM on the task scheduler — the paper's application.

Two level-synchronous task granularities:

  granularity="candidate"    one task per candidate k-itemset (paper §2).
      The per-task join reuses a per-worker-thread LRU cache of *prefix
      intersections*: tasks that share a (k-1)-prefix hit the cache iff
      they run back-to-back on the same worker — exactly the locality
      the clustered policy creates and the Cilk-style policy destroys.
  granularity="bucket"       one task per (k-1)-prefix bucket (default).
      The task resolves its prefix intersection ONCE (to an arena
      handle) and enqueues one handle-based SweepRequest on the sweep
      dispatcher, which coalesces many workers' buckets into batched
      kernel launches (repro_torch.core.join_backend). A driver barrier
      separates level k from k+1.

Every bitmap lives in one ``BitmapArena`` (repro_torch.core.tidlist):
item bitmaps are loaded once (handle == item id), prefix intersections
are refcounted arena rows, and the arena's device mirror is synced
incrementally — repeated sweeps cost ~one initial upload
(``MiningMetrics.h2d_bytes``) instead of one upload per sweep.

Depth-first and ``auto`` granularity, multi-device meshes, multi-host
runs, streaming deltas and tracing belong to later slices of the port
and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import tidlist
from repro_torch.core.buckets import (REPRESENTATIONS, Bucket, DensityModel,
                                      group_by_prefix, rows_to_bytes)
from repro_torch.core.itemsets import Itemset, gen_candidates, prefix_hash
from repro_torch.core.join_backend import (FLUSH_US, MAX_BATCH,
                                           SweepDispatcher, resolve_backend)
from repro_torch.core.scheduler import TaskScheduler, make_policy
from repro_torch.core.tidlist import BitmapArena
from repro_torch.obs import MetricsRegistry
from repro_torch.obs import schema as obs_schema

GRANULARITIES = ("bucket", "candidate")


def resolve_device(device: "torch.device | str | None") -> torch.device:
    """``None`` means the CUDA card. Asking for CUDA on a host without
    one raises at once: the CPU runs only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to mine on "
            "the host")
    return dev


@dataclass
class MiningMetrics:
    wall_s: float = 0.0
    levels: int = 0
    candidates: int = 0
    buckets: int = 0
    frequent: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    cache_partial_hits: int = 0
    rows_touched: int = 0        # bitmap rows actually read (measured)
    bytes_swept: int = 0         # rows_touched * W * 4
    # arena gauges: how many non-base rows (cached prefix intersections)
    # were alive at once, and the bitmap payload uploaded host→device
    peak_retained_bitmaps: int = 0
    peak_bytes_retained: int = 0
    h2d_bytes: int = 0
    # dispatcher gauges: batched launches and their mean occupancy
    # (sweep requests per flush; >1 means coalescing actually happened)
    flushes: int = 0
    batch_occupancy: float = 0.0
    per_device: List[Dict[str, float]] = field(default_factory=list)
    scheduler: Dict[str, float] = field(default_factory=dict)
    # hybrid-representation gauges: sweeps split by the prefix row's
    # representation, the byte share of bytes_swept that went through
    # the sparse (gather-intersect) path, sparse rows pushed, both
    # conversion directions, and the density model's decisions
    representation: str = "bitmap"
    dense_sweeps: int = 0
    sparse_sweeps: int = 0
    sparse_bytes_swept: int = 0
    sparse_rows: int = 0
    densify_ops: int = 0
    densify_bytes: int = 0
    sparsify_ops: int = 0
    sparsify_bytes: int = 0
    rep_picks: Dict[str, int] = field(default_factory=dict)

    @property
    def cache_hit_rate(self) -> float:
        t = self.cache_hits + self.cache_misses
        return self.cache_hits / t if t else 0.0


class _PrefixCache:
    """LRU of prefix -> arena handle of the intersected bitmap (one
    instance per worker).

    *Hierarchical*: a miss on ABC first checks AB — if present, only one
    extra AND is needed. ``get`` also returns the number of bitmap rows
    it read to build the intersection (0 on a full hit) — the measured
    locality traffic.

    Ownership contract: the cache owns one arena reference per entry
    (``push`` grants it; eviction releases), and ``get`` retains a
    SECOND reference on the caller's behalf before returning — the
    caller must release it when done. This keeps a handle live across
    the async dispatcher flight even if the entry is evicted meanwhile,
    and makes ``cache_size=0`` a valid "no cache" setting."""

    def __init__(self, arena: BitmapArena, maxsize: int = 32,
                 model: Optional[DensityModel] = None):
        self.arena = arena
        self.maxsize = maxsize
        self.model = model        # density model: sparse-worthy prefix
                                  # intersections are pushed as
                                  # tid-lists instead of word-columns
        self.d: "collections.OrderedDict[Itemset, int]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.partial_hits = 0

    def _put(self, prefix: Itemset, handle: int):
        self.d[prefix] = handle
        if len(self.d) > self.maxsize:
            _, old = self.d.popitem(last=False)
            self.arena.release(old)

    def get(self, prefix: Itemset) -> Tuple[int, int]:
        """(caller-retained arena handle, bitmap rows read to build
        it). The caller must ``release`` the handle when done."""
        d = self.d
        arena = self.arena
        if prefix in d:
            d.move_to_end(prefix)
            self.hits += 1
            h = d[prefix]
            arena.retain(h)
            return h, 0
        self.misses += 1
        # hierarchical fallback: longest cached ancestor prefix
        for cut in range(len(prefix) - 1, 1, -1):
            parent = prefix[:cut]
            if parent in d:
                d.move_to_end(parent)
                self.partial_hits += 1
                bm = arena.row(d[parent])
                for item in prefix[cut:]:
                    bm = bm & arena.row(item)
                rows_read = len(prefix) - cut
                break
        else:
            bm = arena.row(prefix[0]).copy()
            for item in prefix[1:]:
                bm &= arena.row(item)
            rows_read = len(prefix)
        if (self.model is not None and self.model.pick_rep(
                int(tidlist.popcount32(bm).sum())) != "bitmap"):
            h = arena.sparsify_push(bm)
        else:
            h = arena.push(bm)
        arena.retain(h)           # the caller's reference, BEFORE _put:
        self._put(prefix, h)      # maxsize=0 evicts-and-releases at once
        return h, rows_read

    def drain(self) -> None:
        """Release every cached handle."""
        while self.d:
            _, h = self.d.popitem(last=False)
            self.arena.release(h)


def _raise_task_errors(tasks) -> None:
    """Surface the first task-body exception on the driver thread (the
    scheduler records it instead of letting the worker die, which would
    deadlock wait_all)."""
    for t in tasks:
        if t.error is not None:
            raise t.error


def _level1(bitmaps: np.ndarray, min_support: int, counts=None
            ) -> Tuple[Dict[Itemset, int], List[Itemset]]:
    """Level 1: dense popcount, no tasks. ``counts`` short-circuits the
    popcount with per-item ones counts a caller already has."""
    supports = (np.asarray(counts) if counts is not None
                else tidlist.popcount32(bitmaps).sum(axis=1))
    result: Dict[Itemset, int] = {
        (i,): int(supports[i]) for i in range(bitmaps.shape[0])
        if supports[i] >= min_support}
    return result, sorted(result)


def _cluster_fn(granularity: str, policy: str):
    """Task attr -> queue-bucket key. attr = (prefix_hash, itemset-or-
    prefix): the hash is the paper's XOR'd prefix hash, precomputed once
    so queue ops stay O(1). The nearest-neighbour policy keys buckets by
    the prefix tuple itself (it needs item overlap between bucket keys).
    """
    if granularity == "candidate":
        return ((lambda a: a[1][:-1]) if policy == "nn"
                else (lambda a: a[0]))
    return ((lambda a: a[1]) if policy == "nn"
            else (lambda a: a[0]))


class EngineRuntime:
    """The engine substrate: one scheduler plus one sweep dispatcher
    over the arena. ``mine`` builds one per call and tears it down with
    the run."""

    def __init__(self, store: BitmapArena, *, policy: str = "clustered",
                 n_workers: int = 8, granularity: str = "bucket",
                 backend: str = "auto", max_batch: int = MAX_BATCH,
                 flush_us: float = FLUSH_US):
        self.store = store
        self.backend = resolve_backend(backend)
        self.dispatchers = [SweepDispatcher(
            store, self.backend, n_clients=n_workers,
            max_batch=max_batch, flush_us=flush_us)]
        self.sched = TaskScheduler(
            n_workers,
            make_policy(policy, n_workers, _cluster_fn(granularity, policy)))
        # pull-based snapshot API: live gauges, readable any time
        self.registry = MetricsRegistry()
        self.registry.register("scheduler", self.sched.merged_stats)
        self.registry.register(
            "per_device", lambda: [d.stats() for d in self.dispatchers])
        self.registry.register(
            "arena", lambda: {"h2d_bytes": store.h2d_bytes,
                              "live_extra": store.live_extra})

    def shutdown(self) -> None:
        self.sched.shutdown()
        for dispatcher in self.dispatchers:
            dispatcher.stop()


class MiningRun:
    """One mining run's runtime, per-worker prefix caches and metrics,
    built around an arena the caller owns."""

    def __init__(self, store: BitmapArena, *, policy: str,
                 n_workers: int, granularity: str, cache_size: int,
                 backend: str = "auto", max_batch: int = MAX_BATCH,
                 flush_us: float = FLUSH_US,
                 representation: str = "auto", item_counts=None):
        if granularity not in GRANULARITIES:
            raise ValueError(
                f"granularity must be one of {GRANULARITIES}, "
                f"got {granularity!r}")
        if representation not in REPRESENTATIONS:
            raise ValueError(
                f"representation must be one of {REPRESENTATIONS}, "
                f"got {representation!r}")
        self.runtime = EngineRuntime(
            store, policy=policy, n_workers=n_workers,
            granularity=granularity, backend=backend,
            max_batch=max_batch, flush_us=flush_us)
        self.store = store
        self.granularity = granularity
        self.cache_size = cache_size
        self.representation = representation
        # "bitmap" keeps the model out entirely; "auto"/"sparse" seed the
        # density model from per-item ones counts
        self.model = (None if representation == "bitmap"
                      else DensityModel.from_counts(
                          store.n_words, item_counts,
                          force=(None if representation == "auto"
                                 else "sparse")))
        self.dispatchers = self.runtime.dispatchers
        self.sched = self.runtime.sched
        self.metrics = MiningMetrics()
        self.caches: Dict[int, _PrefixCache] = {}   # thread ident -> cache

    def close(self) -> None:
        self.runtime.shutdown()
        for cache in self.caches.values():
            cache.drain()

    def finalize(self, t0: float) -> MiningMetrics:
        """Fill the metrics from scheduler/dispatcher/arena gauges."""
        metrics, store = self.metrics, self.store
        metrics.wall_s = time.perf_counter() - t0
        metrics.scheduler = self.sched.merged_stats()
        metrics.rows_touched = int(metrics.scheduler["rows_touched"])
        metrics.bytes_swept = int(metrics.scheduler["bytes_swept"])
        metrics.cache_hits = sum(c.hits for c in self.caches.values())
        metrics.cache_misses = sum(c.misses for c in self.caches.values())
        metrics.cache_partial_hits = sum(c.partial_hits
                                         for c in self.caches.values())
        metrics.per_device = [d.stats() for d in self.dispatchers]
        metrics.flushes = sum(int(row["flushes"])
                              for row in metrics.per_device)
        total_requests = sum(int(row["sweep_requests"])
                             for row in metrics.per_device)
        metrics.batch_occupancy = (total_requests / metrics.flushes
                                   if metrics.flushes else 0.0)
        metrics.h2d_bytes = store.h2d_bytes
        metrics.peak_retained_bitmaps = store.peak_live_extra
        metrics.peak_bytes_retained = store.peak_bytes_extra
        metrics.representation = self.representation
        metrics.dense_sweeps = int(metrics.scheduler["dense_sweeps"])
        metrics.sparse_sweeps = int(metrics.scheduler["sparse_sweeps"])
        metrics.sparse_bytes_swept = int(
            metrics.scheduler["sparse_bytes_swept"])
        metrics.sparse_rows = store.sparse_pushed
        metrics.densify_ops = store.densify_ops
        metrics.densify_bytes = store.densify_bytes
        metrics.sparsify_ops = store.sparsify_ops
        metrics.sparsify_bytes = store.sparsify_bytes
        if self.model is not None:
            metrics.rep_picks = {"bitmap": self.model.bitmap_picks,
                                 "tidlist": self.model.tidlist_picks,
                                 "diffset": self.model.diffset_picks}
        return metrics


def mine(bitmaps: np.ndarray, min_support: int, *,
         device: "torch.device | str | None" = None,
         policy: str = "clustered", n_workers: int = 8,
         max_k: int = 8, cache_size: int = 32,
         granularity: str = "bucket", backend: str = "auto",
         max_batch: int = MAX_BATCH, flush_us: float = FLUSH_US,
         representation: str = "auto", item_counts=None,
         mesh=None, hosts: int = 1, trace=None,
         ) -> Tuple[Dict[Itemset, int], MiningMetrics]:
    """bitmaps: [n_items, W] uint32 packed TID bitmaps.

    ``device`` is where the arena's mirror lives and the kernels run:
    ``None`` means the CUDA card and raises ``RuntimeError`` at once when
    there is none; ``"cpu"`` runs the kernels' plain versions on the
    host. ``backend`` names the sweep executor: "auto" (the kernel
    backend, "torch") or "numpy" (the host path, only when named).
    ``granularity`` selects the unit of scheduler task: "bucket" (one
    task per (k-1)-prefix, batched extension sweep) or "candidate" (one
    scalar join per candidate). ``representation`` selects the row
    representation of prefix intersections: "bitmap" (word-columns
    only), "sparse" (tid-lists wherever legal), or "auto" (density-driven
    choice; the default). ``item_counts`` passes per-item ones counts a
    caller already has (``pack_database(..., return_counts=True)``).
    ``max_batch``/``flush_us`` tune the sweep dispatcher's coalescing
    (requests per launch / straggler wait).

    ``mesh``, ``hosts`` and ``trace`` (and the depth-first and auto
    granularities) are the reference engine's options that later slices
    of the port cover; here they raise ``NotImplementedError``."""
    dev = resolve_device(device)
    if granularity in ("depth-first", "auto"):
        raise NotImplementedError(
            f"granularity={granularity!r} comes with the port's "
            "depth-first slice")
    if mesh is not None:
        raise NotImplementedError("mesh= comes with the port's "
                                  "multi-device slice")
    if hosts > 1:
        raise NotImplementedError("hosts > 1 comes with the port's "
                                  "cluster slice")
    if trace is not None:
        raise NotImplementedError("trace= comes with the port's "
                                  "tracing slice")
    store = BitmapArena.from_bitmaps(bitmaps, device=dev)
    t0 = time.perf_counter()
    # level 1 before the runtime spins up worker/dispatcher threads:
    # if it raises there is nothing to tear down
    if item_counts is None:
        item_counts = tidlist.popcount32(bitmaps).sum(axis=1)
    result, frequent = _level1(bitmaps, min_support, counts=item_counts)
    run = MiningRun(store, policy=policy, n_workers=n_workers,
                    granularity=granularity, cache_size=cache_size,
                    backend=backend, max_batch=max_batch,
                    flush_us=flush_us, representation=representation,
                    item_counts=item_counts)
    run.metrics.frequent += len(frequent)
    try:
        mine_more(run, min_support, max_k, result, frequent)
    finally:
        run.close()
    return result, run.finalize(t0)


def mine_more(run: MiningRun, min_support: int, max_k: int,
              result: Dict[Itemset, int], frequent: List[Itemset],
              delta=None) -> None:
    """Mine levels ≥ 2 on an existing run, starting from the level-1
    ``frequent`` itemsets. ``delta`` (a streaming refresh plan) comes
    with the port's streaming slice."""
    if delta is not None:
        raise NotImplementedError("delta= comes with the port's "
                                  "streaming slice")
    _mine_levelwise(run.store, run.dispatchers[0], min_support, max_k,
                    run.sched, run.metrics, result, frequent,
                    run.granularity, run.cache_size, run.caches,
                    model=run.model)


def _mine_levelwise(store, dispatcher, min_support, max_k, sched,
                    metrics, result, frequent, granularity, cache_size,
                    caches, model=None):
    """Level-synchronous engine: plan level k, spawn, barrier, plan
    level k+1 (the paper's §2 shape, at candidate or bucket grain).
    Candidate tasks join on the host directly; bucket tasks sweep
    through the dispatcher."""
    n_w = store.n_words
    lock = threading.Lock()

    def _thread_cache() -> _PrefixCache:
        tid = threading.get_ident()
        c = caches.get(tid)
        if c is None:
            with lock:
                c = caches.setdefault(
                    tid, _PrefixCache(store, cache_size, model=model))
        return c

    def _prefix_handle(cache: _PrefixCache, prefix: Itemset
                       ) -> Tuple[int, int]:
        """Caller-retained handle (release when done; a no-op for the
        pinned base rows at k=2) + rows read to build it."""
        if len(prefix) == 1:
            return prefix[0], 1                 # base row; no reuse at k=2
        return cache.get(prefix)

    def _account(rows: int) -> None:
        st = sched.worker_stats()
        st.rows_touched += rows
        st.bytes_swept += rows_to_bytes(rows, n_w)

    def count_task(cand: Itemset) -> int:
        cache = _thread_cache()
        ph, prows = _prefix_handle(cache, cand[:-1])
        try:
            _account(prows + 1)
            st = sched.worker_stats()
            if store.rep_of(ph) != tidlist.REP_BITMAP:
                st.sparse_sweeps += 1
                st.sparse_bytes_swept += len(store.tids_of(ph)) * 4
                # cached sparse prefixes are tid-lists (never
                # diffsets), so the gather count IS the support
                return int(tidlist.gather_count(store.tids_of(ph),
                                                store.row(cand[-1])))
            st.dense_sweeps += 1
            return int(tidlist.popcount32(store.row(ph)
                                          & store.row(cand[-1])).sum())
        finally:
            store.release(ph)

    def sweep_task(bucket: Bucket) -> np.ndarray:
        """Bucket-granularity body: resolve the prefix handle once, then
        one handle-based request on the dispatcher (which batches it
        with other workers' buckets). Returns [E] counts."""
        cache = _thread_cache()
        ph, prows = _prefix_handle(cache, bucket.prefix)
        try:
            _account(prows + len(bucket.exts))
            st = sched.worker_stats()
            st.sweeps_submitted += 1
            if store.rep_of(ph) != tidlist.REP_BITMAP:
                st.sparse_sweeps += 1
                st.sparse_bytes_swept += (len(store.tids_of(ph)) * 4
                                          * len(bucket.exts))
            else:
                st.dense_sweeps += 1
            return dispatcher.sweep(ph, bucket.exts)
        finally:
            store.release(ph)

    def _spawn_sweeps(cands):
        """Spawn sweeps for ``cands`` (bucket- or candidate-grained) and
        return a collector to call AFTER ``wait_all``."""
        if granularity == "bucket":
            plan = group_by_prefix(cands)
            metrics.buckets += len(plan)
            tasks = [sched.spawn(sweep_task, b, attr=(b.key, b.prefix))
                     for b in plan]

            def collect():
                _raise_task_errors(tasks)
                return [(b.prefix + (e,), int(s))
                        for b, t in zip(plan, tasks)
                        for e, s in zip(b.exts, t.result)]
        else:
            tasks = [sched.spawn(count_task, c, attr=(prefix_hash(c), c))
                     for c in cands]

            def collect():
                _raise_task_errors(tasks)
                return [(c, int(t.result)) for c, t in zip(cands, tasks)]
        return collect

    k = 2
    while frequent and k <= max_k:
        cands = gen_candidates(frequent)
        if not cands:
            break
        metrics.levels += 1
        metrics.candidates += len(cands)
        frequent = []
        collect = _spawn_sweeps(cands)
        sched.wait_all()
        for c, s in collect():
            if s >= min_support:
                result[c] = s
                frequent.append(c)
        frequent.sort()
        metrics.frequent += len(frequent)
        k += 1


def mine_serial(bitmaps: np.ndarray, min_support: int, max_k: int = 8
                ) -> Dict[Itemset, int]:
    """Single-threaded host reference (no scheduler, no device)."""
    result, frequent = _level1(bitmaps, min_support)
    k = 2
    while frequent and k <= max_k:
        cands = gen_candidates(frequent)
        frequent = []
        for c in cands:
            s = tidlist.support_of(bitmaps[list(c)])
            if s >= min_support:
                result[c] = s
                frequent.append(c)
        frequent.sort()
        k += 1
    return result
