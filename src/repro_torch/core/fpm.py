"""Apriori/Eclat FPM on the task scheduler — the paper's application.

Three task granularities, and ``auto`` between them:

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
  granularity="depth-first"  barrier-free equivalence-class recursion.
      Each task owns one class (prefix P, sibling extensions E): it
      sweeps E through the dispatcher, records the frequent extensions,
      forms the child classes P+(e,) × {siblings > e} Eclat-style (no
      global candidate generation), materializes each child's row
      exactly once into the arena and hands the child task the handle,
      so no child recomputes or cache-probes a prefix intersection.
      Children spawn onto the spawning worker's queue; one terminal
      ``wait_all`` replaces every inter-level barrier.
  granularity="auto"         the bucket engine, with model-chosen
      buckets detached into depth-first class tasks mid-run.

Every bitmap lives in one ``BitmapArena`` (repro_torch.core.tidlist):
item bitmaps are loaded once (handle == item id), prefix intersections
and child handoffs are refcounted arena rows, and the arena's device
mirror is synced incrementally — repeated sweeps cost ~one initial
upload (``MiningMetrics.h2d_bytes``) instead of one upload per sweep.

``mine(trace=Tracer())`` records the run's timeline (repro_torch.obs):
worker task/steal/park/prefix spans, dispatcher flush and launch spans,
the arena's mirror syncs, the driver's arena build, level 1 and level
spans (each level's candidates, plan and collect inside), and the
call's garbage collections. ``mine_more(delta=)`` is the
streaming refresh's incremental re-mine (``DeltaPlan``; driven by
``repro_torch.core.streaming``). ``mine(hosts=N)`` runs the same
engines over N word-sliced host arenas with two-phase support counting
(``repro_torch.core.cluster``). ``mine(mesh=...)`` runs the same engines,
every granularity and policy, over device shards: the arena keeps one
set of mirrors per shard (item rows replicated, a made row owned by the
shard that made it), one dispatcher per shard sweeps through a kernel
backend of its own, workers are pinned to shards, and a cross-shard
bucket steal migrates the bucket's handoff rows. Cross-shard traffic is
``MiningMetrics.d2d_bytes``, rows re-owned ``migrations``.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import tidlist
from repro_torch.core.buckets import (REPRESENTATIONS, Bucket, DensityModel,
                                      class_rows_touched, gen_buckets,
                                      rows_to_bytes)
from repro_torch.core.itemsets import Itemset, gen_candidates, itemset_hash
from repro_torch.core.join_backend import (FLUSH_US, MAX_BATCH,
                                           SweepDispatcher, resolve_backend)
from repro_torch.core.known import (EXT_DTYPE, SUP_DTYPE, KnownStore,
                                    bucket_keys, ext_array, find)
from repro_torch.core.scheduler import TaskScheduler, make_policy
from repro_torch.core.tidlist import BitmapArena, resolve_device
from repro_torch.obs import MetricsRegistry
from repro_torch.obs import schema as obs_schema
from repro_torch.obs.tracer import with_gc_spans

GRANULARITIES = ("bucket", "candidate", "depth-first", "auto")
# trace category of the host work that keeps the card waiting (arena
# build, level 1, level planning and collection, prefix building, the
# stream's delta bookkeeping): a category of its own, so the time-in-
# state accounting bills it to "other", never to eval or sweep
HOST_CAT = "host"


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
    # arena gauges: how many non-base rows (cached prefix intersections
    # + depth-first handoff rows) were alive at once, and the bitmap
    # payload uploaded host→device
    peak_retained_bitmaps: int = 0
    peak_bytes_retained: int = 0
    h2d_bytes: int = 0
    # dispatcher gauges: batched launches and their mean occupancy
    # (sweep requests per flush; >1 means coalescing actually happened)
    flushes: int = 0
    batch_occupancy: float = 0.0
    # mesh gauges: shards in the run, modeled cross-shard row traffic
    # (on-demand foreign fetches + steal migrations), rows re-owned by
    # migration, and one dispatcher stats row per shard
    n_devices: int = 1
    d2d_bytes: int = 0
    migrations: int = 0
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
    # multi-host gauges (cluster runs only): hosts in the run, bytes that
    # crossed (or, loopback, would have crossed) the interconnect
    # (descriptor flushes + count replies + level exchanges + steal
    # migrations), the steal share of them, cross-host steals, and one
    # row per host (bytes swept, local sweep and peer-evaluation time)
    n_hosts: int = 1
    net_bytes: int = 0
    steal_net: int = 0
    cross_steals: int = 0
    per_host: List[Dict[str, float]] = field(default_factory=list)

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
    and makes ``cache_size=0`` a valid "no cache" setting.

    The depth-first engine never touches this cache: the parent→child
    handle handoff makes it vestigial there (cache_misses == 0)."""

    def __init__(self, arena: BitmapArena, maxsize: int = 32,
                 shard: int = 0, upto: Optional[int] = None,
                 model: Optional[DensityModel] = None):
        self.arena = arena
        self.maxsize = maxsize
        self.model = model        # density model: sparse-worthy prefix
                                  # intersections are pushed as
                                  # tid-lists instead of word-columns
        self.shard = shard        # rows this cache pushes are owned by
                                  # the caching worker's shard
        self.upto = upto          # segment boundary: builds read (and
                                  # pushed rows cover) only the first
                                  # ``upto`` segments, so an ingest
                                  # landing mid-refresh cannot change a
                                  # row's width between two reads
        self.d: "collections.OrderedDict[Itemset, int]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.partial_hits = 0

    def _row(self, h: int) -> np.ndarray:
        if self.upto is None:
            return self.arena.row(h)
        return self.arena.row_upto(h, self.upto)

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
        tr = arena.tracer
        t0 = tr.now() if tr is not None else 0.0
        # hierarchical fallback: longest cached ancestor prefix
        for cut in range(len(prefix) - 1, 1, -1):
            parent = prefix[:cut]
            if parent in d:
                d.move_to_end(parent)
                self.partial_hits += 1
                bm = self._row(d[parent])
                for item in prefix[cut:]:
                    bm = bm & self._row(item)
                rows_read = len(prefix) - cut
                break
        else:
            bm = self._row(prefix[0]).copy()
            for item in prefix[1:]:
                bm &= self._row(item)
            rows_read = len(prefix)
        rep = "bitmap"
        if self.model is not None:
            rep = self.model.pick_rep(int(tidlist.popcount32(bm).sum()))
        if rep != "bitmap":
            h = arena.sparsify_push(bm, shard=self.shard, cover=self.upto)
        else:
            h = arena.push(bm, shard=self.shard, cover=self.upto)
        arena.retain(h)           # the caller's reference, BEFORE _put:
        self._put(prefix, h)      # maxsize=0 evicts-and-releases at once
        if tr is not None:
            # a worker-lane child of its task span, in no sweep state
            tr.span("prefix", t0, cat=HOST_CAT,
                    args={"rows_read": rows_read, "rep": rep})
        return h, rows_read

    def drain(self) -> None:
        """Release every cached handle. A streaming arena outlives the
        run, so rows a dead cache pinned would never recycle (and would
        lack every later segment's words)."""
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


def _resolve_mesh(mesh) -> Tuple[int, Optional[List[torch.device]]]:
    """``mesh=`` is None (a shared-memory run), an int (that many logical
    shards, all on the run's device: ownership, affinity and d2d
    accounting with one set of mirrors per shard) or a list or tuple of
    ``torch.device`` (one shard per device, its mirrors there). Returns
    (n_shards, devices or None)."""
    if mesh is None:
        return 1, None
    if isinstance(mesh, int):
        if mesh < 1:
            raise ValueError(f"mesh must be >= 1 shards, got {mesh}")
        return mesh, None
    if isinstance(mesh, (list, tuple)) and mesh:
        return len(mesh), [torch.device(d) for d in mesh]
    raise ValueError(f"mesh must be None, an int or a non-empty list of "
                     f"devices, got {mesh!r}")


def mesh_over_devices(n: int) -> "int | List[torch.device] | None":
    """The launcher's ``--mesh N``: the first N CUDA devices when the
    host has that many, else N logical shards (the int form of
    ``mine``'s ``mesh=``); None for ``n <= 1``, a shared-memory run."""
    if n <= 1:
        return None
    if torch.cuda.device_count() >= n:
        return [torch.device(f"cuda:{i}") for i in range(n)]
    return n


@dataclass
class DeltaPlan:
    """Incremental re-mine instructions that ``StreamingMiner.refresh``
    threads through the engines (None on a batch ``mine``).

    ``known`` holds every candidate ever swept (frequent AND negative
    border) with its exact support over the segments refreshed so far,
    bucket by bucket (:class:`~repro_torch.core.known.KnownStore`; a
    mapping given here is converted); the engines update it in place
    (under ``lock`` on the depth-first path, where class tasks merge
    concurrently). ``dirty_items`` are the items occurring in the
    pending segments: a candidate's support may have changed iff EVERY
    item of it is dirty. ``segments`` are the pending segment ids a
    dirty candidate's delta sweep reads; ``base_segments`` are the
    segments a FULL (fresh-candidate) sweep reads — the refresh
    generation boundary, so an ingest landing mid-refresh never leaks
    into this generation's supports. ``priority_of(prefix)`` (optional)
    is the staleness-hotness carried on spawned tasks, so the clustered
    policies drain stale-hot buckets first; None skips priority stamping
    entirely. ``tenant`` tags every spawned task for the scheduler's
    weighted-fair drain (None on single-tenant runs). Clean known
    candidates are never swept at all."""
    known: KnownStore
    dirty_items: frozenset
    segments: Tuple[int, ...]
    base_segments: Tuple[int, ...]
    priority_of: Optional[Callable[[Itemset], float]] = None
    tenant: object = None
    lock: threading.Lock = field(default_factory=threading.Lock)
    # refresh-side counters (how much re-mining the plan avoided)
    swept_full: int = 0
    swept_delta: int = 0
    reused: int = 0
    # per prefix, the sorted extensions the engines swept in this
    # refresh (fresh or dirty)
    swept: Dict[Itemset, np.ndarray] = field(default_factory=dict)
    # dirty_items as a mask over item ids; one slot past the largest
    # dirty item stands for every larger (clean) one
    _dirty: np.ndarray = field(init=False, repr=False)

    def __post_init__(self):
        if not isinstance(self.known, KnownStore):
            self.known = KnownStore(self.known)
        items = np.fromiter(self.dirty_items, np.int64)
        self._dirty = np.zeros(int(items.max(initial=-1)) + 2, bool)
        self._dirty[items] = True

    def is_dirty(self, c: Itemset) -> bool:
        d = self.dirty_items
        return all(i in d for i in c)

    def dirty_of(self, items: np.ndarray) -> np.ndarray:
        """Per item of ``items``: is it dirty."""
        d = self._dirty
        return d[np.minimum(items, len(d) - 1)]

    def classify_buckets(self, plan: List[Bucket]
                         ) -> Tuple["_Level", int, List[Bucket],
                                    List[Bucket]]:
        """Split a level's prefix buckets by masks, the whole level at
        once: returns (the level aligned with ``known``, for
        :meth:`fold` and :meth:`threshold`; the number of clean known
        candidates; dirty sub-buckets; fresh sub-buckets). The buckets'
        extensions are laid end to end and aligned with the stored ones
        in one search, each prefix's dirtiness is probed ONCE, and dirty
        and fresh extensions stay bucketed so neither sweep path
        re-groups them. No itemset tuple is built."""
        prefixes = [b.prefix for b in plan]
        lens = np.fromiter((len(b.exts) for b in plan), np.int64, len(plan))
        exts = np.fromiter(itertools.chain.from_iterable(b.exts
                                                         for b in plan),
                           EXT_DTYPE, int(lens.sum()))
        s_exts, s_sups, s_lens = self.known.gather(prefixes)
        s_keys = bucket_keys(s_lens, s_exts)
        keys = bucket_keys(lens, exts)
        pos, found = find(s_keys, keys)
        p_dirty = np.fromiter(map(self.is_dirty, prefixes), bool, len(plan))
        dirty_m = found & np.repeat(p_dirty, lens) & self.dirty_of(exts)
        fresh_m = ~found
        swept_m = dirty_m | fresh_m
        level = _Level(prefixes, exts, lens, keys, s_keys, s_sups, s_lens,
                       pos, found, dirty_m, fresh_m)
        dirty: List[Bucket] = []
        fresh: List[Bucket] = []
        starts = np.cumsum(lens) - lens
        n_dirty = np.add.reduceat(dirty_m, starts, dtype=np.int64).tolist()
        n_fresh = np.add.reduceat(fresh_m, starts, dtype=np.int64).tolist()
        for b, a, n, nd, nf in zip(plan, starts.tolist(), lens.tolist(),
                                   n_dirty, n_fresh):
            if nd + nf:
                ex = exts[a:a + n]
                self.swept[b.prefix] = (ex if nd + nf == n
                                        else ex[swept_m[a:a + n]])
                if nd:
                    dirty.append(_sub_bucket(b, ex, dirty_m[a:a + n], nd))
                if nf:
                    fresh.append(_sub_bucket(b, ex, fresh_m[a:a + n], nf))
        n_clean = len(exts) - int(np.count_nonzero(swept_m))
        return level, n_clean, dirty, fresh

    def fold(self, level: "_Level",
             swept: List[Tuple[Bucket, np.ndarray, bool]]) -> np.ndarray:
        """Fold a level's sweeps into ``known`` and return every
        candidate's support, laid out as ``level.exts``. ``swept`` holds
        ``(sub-bucket, counts, fresh)`` in any order: fresh counts are
        supports, the others deltas over the pending segments. Clean
        candidates keep their stored supports. Under a cluster this is
        the exchange's update and runs once per known store; every host
        gets the supports back."""
        counts = {(b.prefix, is_fresh): c for b, c, is_fresh in swept}
        sups = np.zeros(len(level.exts), SUP_DTYPE)
        sups[level.found] = level.s_sups[level.pos[level.found]]
        for is_fresh, m in ((False, level.dirty), (True, level.fresh)):
            parts = [counts[p, is_fresh] for p in level.prefixes
                     if (p, is_fresh) in counts]
            if parts:
                got = np.concatenate(parts).astype(SUP_DTYPE)
                sups[m] = got if is_fresh else sups[m] + got
        # write the level back: the stored supports updated, the fresh
        # extensions inserted in order, one new array for the level
        new_sups = level.s_sups.copy()
        new_sups[level.pos[level.found]] = sups[level.found]
        new_keys, new_lens = level.s_keys, level.s_lens
        if level.fresh.any():
            at = level.pos[level.fresh]
            new_keys = np.insert(new_keys, at, level.keys[level.fresh])
            new_sups = np.insert(new_sups, at, sups[level.fresh])
            new_lens = new_lens + np.add.reduceat(
                level.fresh, np.cumsum(level.lens) - level.lens,
                dtype=np.int64)
        self.known.scatter(level.prefixes,
                           (new_keys & 0xFFFFFFFF).astype(EXT_DTYPE),
                           new_sups, new_lens)
        return sups

    @staticmethod
    def threshold(level: "_Level", sups: np.ndarray, min_support: int
                  ) -> List[Tuple[Itemset, int]]:
        """The level's ``(itemset, support)`` pairs at ``min_support`` or
        above, from :meth:`fold`'s supports: a tuple is built only for a
        frequent candidate."""
        hits = np.flatnonzero(sups >= min_support)
        which = (level.keys[hits] >> 32).tolist()
        pre = level.prefixes
        return [(pre[i] + (e,), s) for i, e, s in
                zip(which, level.exts[hits].tolist(), sups[hits].tolist())]

    def mark_swept(self, prefix: Itemset, exts) -> None:
        """Record the extensions of ``prefix`` an engine swept (a class
        task, once per prefix; caller holds ``lock``)."""
        self.swept[prefix] = ext_array(sorted(exts))

    def drop_unswept(self) -> None:
        """Drop every known candidate whose support may have changed (all
        its items dirty) that no engine swept in this refresh. Such a
        candidate fell off the candidate frontier: under a fraction
        threshold one of its subsets died. Its count misses the pending
        segments, and a later delta sweep (pending segments only) would
        never add them, so it must be swept in full if it returns. Under
        a fixed count nothing dies, so the streams call this only under a
        fraction threshold. Works on every dirty prefix's bucket at
        once: a mask of dirty extensions, less the swept ones."""
        known = self.known
        prefixes = [p for p in known.prefixes() if p and self.is_dirty(p)]
        exts, _, lens = known.gather(prefixes)
        none = np.zeros(0, EXT_DTYPE)
        swept = [self.swept.get(p, none) for p in prefixes]
        sw_lens = np.fromiter(map(len, swept), np.int64, len(swept))
        sw = np.concatenate(swept) if swept else none
        _, was_swept = find(bucket_keys(sw_lens, sw),
                            bucket_keys(lens, exts))
        stale = self.dirty_of(exts) & ~was_swept
        ends = np.cumsum(lens).tolist()
        for p, a, z in zip(prefixes, [0] + ends[:-1], ends):
            known.drop(p, stale[a:z])


class _Level(NamedTuple):
    """One level's planned buckets aligned with the known store
    (``DeltaPlan.classify_buckets``): the candidates' extensions laid
    end to end, bucket by bucket, with their sort keys; the planned
    prefixes' stored entries in the same layout; each candidate's slot
    among them, and whether it is stored (``found``), dirty or
    fresh."""
    prefixes: List[Itemset]
    exts: np.ndarray
    lens: np.ndarray
    keys: np.ndarray
    s_keys: np.ndarray
    s_sups: np.ndarray
    s_lens: np.ndarray
    pos: np.ndarray
    found: np.ndarray
    dirty: np.ndarray
    fresh: np.ndarray


def _sub_bucket(b: Bucket, exts: np.ndarray, mask: np.ndarray,
                n: int) -> Bucket:
    """The ``n`` extensions of bucket ``b`` (``exts``) that ``mask``
    selects (``b`` itself when that is all of them)."""
    if n == len(exts):
        return b
    return Bucket(b.key, b.prefix, tuple(exts[mask].tolist()))


class EngineRuntime:
    """The engine substrate: one scheduler with shard-affine workers plus
    one sweep dispatcher per arena shard, each with a kernel backend of
    its own (a ``TorchBackend``'s staging buffers belong to one thread).
    Worker ``i`` runs on shard ``i % n_shards`` (``device_of``), and
    there are at least as many workers as shards; a steal across shards
    migrates the stolen task's rows (``BitmapArena.migrate``).
    ``mine`` builds one per call and tears it down with the run; the
    streaming layer owns ONE across its whole life and lends it to every
    refresh's :class:`MiningRun`, so query sweeps submitted between (and
    during) refreshes land on the same dispatchers as candidate sweeps
    and coalesce into the same flushes. Idle cost is zero: the
    dispatcher threads and the workers park untimed.

    ``cluster`` is a multi-host context (``repro_torch.core.cluster``):
    the dispatcher reduces every flush across hosts through it, and the
    engines partition work and exchange level results through it."""

    def __init__(self, store: BitmapArena, *, policy: str = "clustered",
                 n_workers: int = 8, granularity: str = "bucket",
                 backend: str = "auto", max_batch: int = MAX_BATCH,
                 flush_us: float = FLUSH_US, cluster=None, tracer=None):
        n_shards = store.n_shards
        n_workers = max(n_workers, n_shards)    # >= 1 worker per shard
        self.store = store
        self.cluster = cluster
        # observability (repro_torch.obs): one tracer threaded through
        # every layer this runtime owns — scheduler workers, the
        # dispatcher thread and the arena record into its per-thread
        # rings. None keeps every site on the disabled fast path. In
        # cluster mode the host rank is the Chrome-trace pid, one lane
        # group per host.
        self.trace_pid = cluster.host_id if cluster is not None else 0
        if tracer is not None:
            store.tracer = tracer
        self.device_of = [i % n_shards for i in range(n_workers)]
        self.dispatchers = [SweepDispatcher(
            store, resolve_backend(backend),
            n_clients=self.device_of.count(s), max_batch=max_batch,
            flush_us=flush_us, shard=s, cluster=cluster, tracer=tracer,
            trace_pid=self.trace_pid) for s in range(n_shards)]
        self.sched = TaskScheduler(
            n_workers,
            make_policy(policy, n_workers, _cluster_fn(granularity, policy)),
            device_of=self.device_of,
            migrate_cb=lambda hs, src, dst: store.migrate(hs, dst),
            tracer=tracer, trace_pid=self.trace_pid)
        # pull-based snapshot API: live gauges, readable any time. No
        # gauge refers back to the runtime: a reference cycle would keep
        # a finished run's arena, and its device mirror, alive until the
        # next full collection
        self.registry = MetricsRegistry()
        self.registry.register("scheduler", self.sched.merged_stats)
        dispatchers = self.dispatchers
        self.registry.register(
            "per_device", lambda: [d.stats() for d in dispatchers])
        self.registry.register(
            "arena", lambda: {"h2d_bytes": store.h2d_bytes,
                              "d2d_bytes": store.d2d_bytes,
                              "migrations": store.migrations,
                              "compactions": store.compactions,
                              "compaction_bytes": store.compaction_bytes,
                              "live_extra": store.live_extra})

    def shutdown(self) -> None:
        self.sched.shutdown()
        for dispatcher in self.dispatchers:
            dispatcher.stop()


class MiningRun:
    """One mining run's runtime, per-worker prefix caches and metrics,
    built around an arena the caller owns (a batch run discards it; a
    streaming run keeps it across refreshes).

    ``runtime`` lends a persistent :class:`EngineRuntime` instead of
    building one: the run then reports scheduler and dispatcher gauges
    as DELTAS against construction-time baselines (the shared runtime's
    counters accumulate across refreshes and query traffic), and
    ``close`` drains this run's caches but leaves the runtime alive."""

    def __init__(self, store: BitmapArena, *, policy: str,
                 n_workers: int, granularity: str, cache_size: int,
                 backend: str = "auto", max_batch: int = MAX_BATCH,
                 flush_us: float = FLUSH_US,
                 representation: str = "auto", item_counts=None,
                 runtime: Optional[EngineRuntime] = None,
                 tracer=None):
        if granularity not in GRANULARITIES:
            raise ValueError(
                f"granularity must be one of {GRANULARITIES}, "
                f"got {granularity!r}")
        if representation not in REPRESENTATIONS:
            raise ValueError(
                f"representation must be one of {REPRESENTATIONS}, "
                f"got {representation!r}")
        if runtime is None:
            runtime = EngineRuntime(
                store, policy=policy, n_workers=n_workers,
                granularity=granularity, backend=backend,
                max_batch=max_batch, flush_us=flush_us, tracer=tracer)
            self._owns_runtime = True
        else:
            if runtime.store is not store:
                raise ValueError("runtime was built over a different arena")
            self._owns_runtime = False
        self.runtime = runtime
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
        self.dispatchers = runtime.dispatchers
        self.sched = runtime.sched
        self.metrics = MiningMetrics(n_devices=store.n_shards)
        self.caches: Dict[int, _PrefixCache] = {}   # thread ident -> cache
        # a mesh routes even candidate-grain joins through the shard's
        # dispatcher (every row access is booked to its shard), and so
        # does a cluster (a direct host join would skip the reduction)
        self.sweep_joins = (store.n_shards > 1
                            or runtime.cluster is not None)
        # gauge baselines: zero for an owned runtime, the accumulated
        # counters for a borrowed one — finalize() reports deltas
        self._disp0 = [(d.flushes, d.requests, d.queue_flushes,
                        d.queue_requests, d.query_requests, d.sweep_s)
                       for d in self.dispatchers]
        self._sched0 = self.sched.merged_stats()

    def close(self) -> None:
        if self._owns_runtime:
            self.runtime.shutdown()
        for cache in self.caches.values():
            cache.drain()

    @staticmethod
    def _disp_stats(d, base) -> Dict[str, float]:
        f0, r0, qf0, qr0, q0, s0 = base
        return obs_schema.device_stats(
            {"device": d.shard, "flushes": d.flushes - f0,
             "sweep_requests": d.requests - r0,
             "query_requests": d.query_requests - q0,
             "queue_flushes": d.queue_flushes - qf0,
             "queue_requests": d.queue_requests - qr0,
             "sweep_s": d.sweep_s - s0})

    def finalize(self, t0: float) -> MiningMetrics:
        """Fill the metrics from scheduler/dispatcher/arena gauges.
        Scheduler and dispatcher gauges are deltas against this run's
        construction (the totals for an owned runtime). Arena gauges are
        cumulative over the arena's life: ``mine`` owns a fresh arena, so
        they equal the run's; ``refresh`` reports its own deltas."""
        metrics, store = self.metrics, self.store
        metrics.wall_s = time.perf_counter() - t0
        metrics.scheduler = obs_schema.scheduler_stats(
            obs_schema.delta_counters(self.sched.merged_stats(),
                                      self._sched0,
                                      obs_schema.SCHEDULER_COUNTERS))
        metrics.rows_touched = int(metrics.scheduler["rows_touched"])
        metrics.bytes_swept = int(metrics.scheduler["bytes_swept"])
        metrics.cache_hits = sum(c.hits for c in self.caches.values())
        metrics.cache_misses = sum(c.misses for c in self.caches.values())
        metrics.cache_partial_hits = sum(c.partial_hits
                                         for c in self.caches.values())
        metrics.per_device = [self._disp_stats(d, b)
                              for d, b in zip(self.dispatchers, self._disp0)]
        metrics.flushes = sum(int(row["flushes"])
                              for row in metrics.per_device)
        total_requests = sum(int(row["sweep_requests"])
                             for row in metrics.per_device)
        metrics.batch_occupancy = (total_requests / metrics.flushes
                                   if metrics.flushes else 0.0)
        metrics.h2d_bytes = store.h2d_bytes
        metrics.d2d_bytes = store.d2d_bytes
        metrics.migrations = store.migrations
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
         arena: str = "auto", mesh=None, hosts: int = 1, trace=None,
         ) -> Tuple[Dict[Itemset, int], MiningMetrics]:
    """bitmaps: [n_items, W] uint32 packed TID bitmaps.

    ``device`` is where the arena's mirror lives and the kernels run:
    ``None`` means the CUDA card and raises ``RuntimeError`` at once when
    there is none; ``"cpu"`` runs the kernels' plain versions on the
    host. ``backend`` names the sweep executor: "auto" (the kernel
    backend, "torch") or "numpy" (the host path, only when named).
    ``granularity`` selects the unit of scheduler task: "bucket" (one
    task per (k-1)-prefix, batched extension sweep), "candidate" (one
    scalar join per candidate), "depth-first" (barrier-free
    equivalence-class recursion with parent→child handle handoff), or
    "auto" (the bucket engine, detaching subtrees to depth-first class
    tasks where the density model predicts they win).
    ``representation`` selects the row representation of prefix
    intersections and handoff rows: "bitmap" (word-columns only),
    "sparse" (tid-lists or diffsets wherever legal), or "auto"
    (density-driven choice; the default). ``item_counts`` passes
    per-item ones counts a caller already has
    (``pack_database(..., return_counts=True)``).
    ``max_batch``/``flush_us`` tune the sweep dispatcher's coalescing
    (requests per launch / straggler wait).
    ``arena`` picks the bitmap store's device residency ("auto": lazy
    device mirror; "jax": eager upload to ``device``, named as in the
    reference engine; "numpy": host-only — the kernel backend then
    gathers and uploads each batch's rows, the transfer-bound baseline).
    ``trace`` attaches a :class:`repro_torch.obs.Tracer`: workers, the
    dispatcher, the arena and the driver record span timelines into it
    (export with ``repro_torch.obs.write_chrome_trace``; None = off).
    ``mesh`` runs the same engine over device shards: an int for that
    many logical shards on ``device``, or a list of ``torch.device``, one
    shard each (see :func:`mesh_over_devices`). The arena keeps one set
    of mirrors per shard, each shard has its own dispatcher and kernel
    backend, and workers are pinned to shards; supports are identical,
    cross-shard traffic lands in ``MiningMetrics.d2d_bytes`` and
    ``migrations``, and ``per_device`` has one dispatcher row per shard.
    ``hosts`` > 1 runs the multi-host decomposition instead
    (``repro_torch.core.cluster.mine_cluster``): the transaction axis
    word-partitions over N logical hosts in this process, each with its
    own arena slice on ``device``, scheduler and dispatcher, with
    two-phase support counting and cross-host steals. The supports are
    identical; the cluster traffic lands in ``MiningMetrics.net_bytes``
    and ``steal_net``. Such a run pins ``representation="bitmap"``,
    ignores ``arena`` and takes no ``mesh``."""
    dev = resolve_device(device)
    if hosts > 1:
        if mesh is not None:
            raise ValueError("hosts= and mesh= are mutually exclusive "
                             "(a host owns its whole slice)")
        from repro_torch.core.cluster import mine_cluster
        return with_gc_spans(
            trace, mine_cluster, bitmaps, min_support, hosts=hosts,
            device=dev, policy=policy, n_workers=n_workers, max_k=max_k,
            cache_size=cache_size, granularity=granularity,
            backend=backend, max_batch=max_batch, flush_us=flush_us,
            item_counts=item_counts, tracer=trace)
    return with_gc_spans(trace, _mine_local, bitmaps, min_support, dev,
                         policy, n_workers, max_k, cache_size, granularity,
                         backend, max_batch, flush_us, representation,
                         item_counts, arena, mesh, trace)


def _mine_local(bitmaps, min_support, dev, policy, n_workers, max_k,
                cache_size, granularity, backend, max_batch, flush_us,
                representation, item_counts, arena, mesh, tr):
    """``mine`` on one host: build the arena, count level 1, mine the
    rest on a fresh run."""
    if tr is not None:
        # the calling thread drives the whole call: name its lane before
        # the arena build, so that build and level 1 land on it too
        tr.set_lane("driver", sort_index=0)
        t_build = tr.now()
    n_shards, devices = _resolve_mesh(mesh)
    store = BitmapArena.from_bitmaps(bitmaps, device=dev, backing=arena,
                                     n_shards=n_shards, devices=devices)
    if tr is not None:
        tr.span("arena-build", t_build, cat=HOST_CAT,
                args={"items": bitmaps.shape[0], "words": bitmaps.shape[1]})
    t0 = time.perf_counter()
    t_items = tr.now() if tr is not None else 0.0
    # level 1 before the runtime spins up worker/dispatcher threads:
    # if it raises there is nothing to tear down
    if item_counts is None:
        item_counts = tidlist.popcount32(bitmaps).sum(axis=1)
    result, frequent = _level1(bitmaps, min_support, counts=item_counts)
    if tr is not None:
        tr.span("items", t_items, cat=HOST_CAT,
                args={"frequent": len(frequent)})
    run = MiningRun(store, policy=policy, n_workers=n_workers,
                    granularity=granularity, cache_size=cache_size,
                    backend=backend, max_batch=max_batch,
                    flush_us=flush_us, representation=representation,
                    item_counts=item_counts, tracer=tr)
    run.metrics.frequent += len(frequent)
    try:
        mine_more(run, min_support, max_k, result, frequent)
    finally:
        run.close()
    return result, run.finalize(t0)


def mine_more(run: MiningRun, min_support: int, max_k: int,
              result: Dict[Itemset, int], frequent: List[Itemset],
              delta: Optional[DeltaPlan] = None) -> None:
    """Mine levels ≥ 2 on an existing run, starting from the level-1
    ``frequent`` itemsets — the shared entry point under ``mine``
    (delta=None: sweep everything) and the streaming refresh (delta:
    reuse known supports, delta-sweep dirty candidates over the pending
    segments only, carry staleness priorities)."""
    cluster = run.runtime.cluster
    tr = run.sched.tracer
    if tr is not None:
        # whichever thread drives this run gets the "driver" lane (one
        # per host in cluster mode: drivers are distinct threads)
        tr.set_lane("driver", sort_index=0, pid=run.runtime.trace_pid)
    if run.granularity == "depth-first":
        _mine_depth_first(run.store, run.dispatchers, min_support,
                          max_k, run.sched, run.metrics, result, frequent,
                          delta=delta, model=run.model, cluster=cluster)
    else:
        _mine_levelwise(run.store, run.dispatchers, min_support,
                        max_k, run.sched, run.metrics, result, frequent,
                        run.granularity, run.cache_size, run.caches,
                        sweep_joins=run.sweep_joins, delta=delta,
                        model=run.model, cluster=cluster)


def _mine_levelwise(store, dispatchers, min_support, max_k, sched,
                    metrics, result, frequent, granularity, cache_size,
                    caches, sweep_joins=False, delta=None, model=None,
                    cluster=None):
    """Level-synchronous engine: plan level k, spawn, barrier, plan
    level k+1 (the paper's §2 shape, at candidate or bucket grain).
    Candidate tasks join on the host directly; bucket tasks, every
    segment-restricted sweep and, with ``sweep_joins`` (mesh and cluster
    runs), every candidate join go through the dispatcher of the
    worker's shard (``dispatchers[sched.worker_device()]``).

    With a ``delta`` plan the level's candidates split three ways:
    *clean known* (support unchanged — zero rows touched), *dirty known*
    (delta-swept over only the pending segments, support accumulated
    into ``delta.known``), and *fresh* (never swept — full sweep over
    the generation-boundary segments). Dirty buckets are CHUNKED: one
    scheduler task carries many buckets and submits them as a burst of
    tuple-prefix sweeps — the backend AND-reduces each prefix's base
    rows over only the pending segments, so the delta path never builds
    a full-width prefix intersection and its launches fill like the full
    path's. Tasks carry ``delta.priority_of`` (when set) so the
    clustered policies drain stale-hot prefixes first.

    ``granularity="auto"`` runs this engine with a per-bucket escape
    hatch: when the density model predicts a prefix's subtree is sparse
    (or thin enough that level barriers dominate), the whole bucket
    detaches into a depth-first class task — the subtree mines
    barrier-free and its itemsets never re-enter the level frontier
    (``gen_buckets`` gets the full known-frequent set, so the
    cross-prefix prune stays exact). Under a delta plan auto stays
    level-synchronous: the clean/dirty/fresh split already skips clean
    work, and diffset handoffs are disabled mid-refresh anyway.

    Under a ``cluster`` every host plans the same global frontier, sweeps
    only the prefixes it owns and merges the level's counts in an
    exchange, so every host thresholds identically: the counted pairs,
    or under a delta plan each swept bucket's counts, whose fold into the
    known store runs once per store inside that exchange.

    The level stays bucket-shaped from planning to thresholding
    (``gen_buckets``), and an itemset tuple is built only for a frequent
    candidate: without a delta plan or a cluster the collectors threshold
    a bucket's counts at once; a delta plan classifies, folds and
    thresholds each bucket by masks over its arrays in the known store
    (``DeltaPlan``, ``core/known.py``). Only the cluster exchange of a
    batch mine needs every candidate's pair."""
    n_w = store.n_words
    # cached prefix rows must cover every segment the plan sweeps; max+1
    # because a tenant's segment set is a non-contiguous subset
    upto = ((max(delta.base_segments) + 1)
            if delta is not None and delta.base_segments else None)
    lock = threading.Lock()
    df_miner = None
    detached_tasks: List = []
    if granularity == "auto" and model is not None and delta is None:
        df_miner = _ClassMiner(store, dispatchers, min_support, max_k,
                               sched, metrics, result, model=model)
    prio = delta.priority_of if delta is not None else None
    tenant = delta.tenant if delta is not None else None

    def _thread_cache() -> _PrefixCache:
        tid = threading.get_ident()
        c = caches.get(tid)
        if c is None:
            with lock:
                c = caches.setdefault(
                    tid, _PrefixCache(store, cache_size,
                                      shard=sched.worker_device(),
                                      upto=upto, model=model))
        return c

    def _prefix_handle(cache: _PrefixCache, prefix: Itemset
                       ) -> Tuple[int, int]:
        """Caller-retained handle (release when done; a no-op for the
        pinned base rows at k=2) + rows read to build it."""
        if len(prefix) == 1:
            return prefix[0], 1                 # base row; no reuse at k=2
        return cache.get(prefix)

    def _seg_w(segments) -> int:
        """Words per row a sweep reads: the full width, or only the
        swept segments' words."""
        if segments is None:
            return n_w
        return sum(store.seg_words(g) for g in segments)

    def _account(prows: int, erows: int, segments) -> None:
        """prows prefix-build rows are read full-width; erows extension
        rows only over the swept segments."""
        st = sched.worker_stats()
        st.rows_touched += prows + erows
        st.bytes_swept += (rows_to_bytes(prows, n_w)
                           + rows_to_bytes(erows, _seg_w(segments)))

    def count_task(cand: Itemset, segments=None) -> int:
        cache = _thread_cache()
        ph, prows = _prefix_handle(cache, cand[:-1])
        try:
            _account(prows, 1, segments)
            st = sched.worker_stats()
            sparse = store.rep_of(ph) != tidlist.REP_BITMAP
            if sparse:
                st.sparse_sweeps += 1
                st.sparse_bytes_swept += len(store.tids_of(ph)) * 4
            else:
                st.dense_sweeps += 1
            if sweep_joins or segments is not None:
                st.sweeps_submitted += 1
                disp = dispatchers[sched.worker_device()]
                return int(disp.sweep(ph, (cand[-1],), segments=segments,
                                      desc=cand[:-1])[0])
            if sparse:
                # cached sparse prefixes are tid-lists (never
                # diffsets), so the gather count IS the support
                return int(tidlist.gather_count(store.tids_of(ph),
                                                store.row(cand[-1])))
            return int(tidlist.popcount32(store.row(ph)
                                          & store.row(cand[-1])).sum())
        finally:
            store.release(ph)

    def sweep_task(bucket: Bucket, segments=None) -> np.ndarray:
        """Bucket-granularity body: resolve the prefix handle once, then
        one handle-based request on the worker's shard's dispatcher
        (which batches it with other workers' buckets on that shard).
        ``segments`` restricts the sweep to a segment subset. Returns [E]
        counts."""
        cache = _thread_cache()
        ph, prows = _prefix_handle(cache, bucket.prefix)
        try:
            _account(prows, len(bucket.exts), segments)
            st = sched.worker_stats()
            st.sweeps_submitted += 1
            if store.rep_of(ph) != tidlist.REP_BITMAP:
                st.sparse_sweeps += 1
                st.sparse_bytes_swept += (len(store.tids_of(ph)) * 4
                                          * len(bucket.exts))
            else:
                st.dense_sweeps += 1
            disp = dispatchers[sched.worker_device()]
            return disp.sweep(ph, bucket.exts, segments=segments,
                              desc=bucket.prefix)
        finally:
            store.release(ph)

    def detach_task(bucket: Bucket, own_support: int,
                    psup: Tuple[int, ...]) -> None:
        """granularity="auto" handoff: resolve the bucket's prefix
        handle like a sweep task would, then run the depth-first class
        body inline — its children spawn barrier-free class tasks, and
        this whole subtree leaves the level frontier."""
        cache = _thread_cache()
        ph, prows = _prefix_handle(cache, bucket.prefix)
        _account(prows, 0, None)
        df_miner.class_task(bucket.prefix, ph, bucket.exts, psup,
                            own_support, True)

    def _detach(plan: List[Bucket]) -> List[Bucket]:
        """Spawn a class task for every bucket the model sends depth-
        first; return the buckets that stay level-synchronous."""
        keep = []
        for b in plan:
            ps = result.get(b.prefix)
            if ps is not None and model.pick_granularity(ps) == "depth-first":
                # the class task re-counts its own candidates
                metrics.candidates -= len(b.exts)
                # parent-level sibling supports (for dEclat children):
                # support of prefix[:-1] + (e,), frequent by the Apriori
                # prune, so present in ``result``
                psup = tuple(result[b.prefix[:-1] + (e,)] for e in b.exts)
                detached_tasks.append(
                    sched.spawn(detach_task, b, ps, psup,
                                attr=(b.key, b.prefix)))
            else:
                keep.append(b)
        return keep

    def _spawn_sweeps(plan: List[Bucket], segments):
        """Spawn sweeps for the ``plan``'s buckets (bucket- or candidate-
        grained) and return ``(swept, collect)``: the buckets swept (a
        cluster host's own, less any detached) and a collector to call
        AFTER ``wait_all`` — fresh and dirty sweep sets share one level
        barrier — that returns each swept bucket's [E] counts."""
        if cluster is not None:
            # every host plans the same global frontier but sweeps only
            # the prefixes it owns; the level exchange merges the pairs
            plan = [b for b in plan if cluster.owns(b.prefix)]
        if granularity in ("bucket", "auto"):
            if df_miner is not None:
                plan = _detach(plan)
            metrics.buckets += len(plan)
            tasks = [sched.spawn(sweep_task, b, segments,
                                 attr=(b.key, b.prefix),
                                 priority=prio(b.prefix) if prio else 0.0,
                                 tenant=tenant)
                     for b in plan]

            def collect():
                _raise_task_errors(tasks)
                return [t.result for t in tasks]
        else:
            # candidate grain: the buckets flattened in order are the
            # sequence ``gen_candidates`` gives
            cands = [(b, b.prefix + (e,)) for b in plan for e in b.exts]
            tasks = [sched.spawn(count_task, c, segments,
                                 attr=(b.key, c),
                                 priority=prio(b.prefix) if prio else 0.0,
                                 tenant=tenant)
                     for b, c in cands]

            def collect():
                _raise_task_errors(tasks)
                if not plan:
                    return []
                counts = np.fromiter((t.result for t in tasks), np.int64,
                                     len(tasks))
                return np.split(counts,
                                np.cumsum([len(b.exts) for b in plan])[:-1])
        return plan, collect

    def _threshold(plan: List[Bucket], counts, floor: int):
        """The ``(itemset, support)`` pairs with support at ``floor`` or
        above (every pair at 0), a bucket's counts at once: no tuple is
        built for a candidate below the floor."""
        out = []
        for b, c in zip(plan, counts):
            hits = np.flatnonzero(c >= floor)
            p, exts = b.prefix, b.exts
            out.extend((p + (exts[i],), s) for i, s in
                       zip(hits.tolist(), c[hits].tolist()))
        return out

    def delta_chunk_task(chunk: List[Bucket]) -> List[np.ndarray]:
        """Coalesced dirty-candidate burst: each bucket in the chunk
        becomes ONE tuple-prefix sweep over the pending segments, and
        the whole chunk executes as one burst — on this worker thread
        for the host backend, as dispatcher flushes for the kernel
        backend. No prefix bitmap is ever built on the host. Returns
        each bucket's [E] delta counts."""
        st = sched.worker_stats()
        counts = dispatchers[sched.worker_device()].sweep_local(
            [((b.prefix if len(b.prefix) > 1 else b.prefix[0]), b.exts)
             for b in chunk],
            segments=delta.segments)
        st.sweeps_submitted += len(chunk)
        rows = sum(len(b.prefix) + len(b.exts) for b in chunk)
        st.rows_touched += rows
        st.bytes_swept += rows_to_bytes(rows, _seg_w(delta.segments))
        return counts

    def _spawn_delta_chunks(plan: List[Bucket]):
        """Spawn a handful of chunk tasks (≈4 per worker) over the
        classified dirty buckets instead of one task per bucket:
        per-task scheduler and future overhead would otherwise cost more
        than the few-word sweeps themselves. The collector returns each
        bucket's [E] delta counts."""
        if not plan:
            return lambda: []
        metrics.buckets += len(plan)
        n_chunks = max(1, 4 * sched.n)
        size = max(1, -(-len(plan) // n_chunks))
        tasks = [sched.spawn(delta_chunk_task, plan[i:i + size],
                             attr=(plan[i].key, plan[i].prefix),
                             tenant=delta.tenant)
                 for i in range(0, len(plan), size)]

        def collect():
            _raise_task_errors(tasks)
            return [c for t in tasks for c in t.result]
        return collect

    k = 2
    tr = sched.tracer
    while frequent and k <= max_k:
        t_level = tr.now() if tr is not None else 0.0
        # detached subtrees' itemsets never rejoin ``frequent``, so the
        # Apriori prune needs the full known-frequent membership (the
        # result dict is complete here: the level barrier below also
        # waited on every detached class task)
        plan = (gen_buckets(frequent, known_frequent=result)
                if df_miner is not None else gen_buckets(frequent))
        n_cands = sum(len(b.exts) for b in plan)
        if tr is not None:
            # driver-lane children of the level span: the host's serial
            # work before the first task and after the barrier
            tr.span("candidates", t_level, cat=HOST_CAT,
                    args={"candidates": n_cands})
            t_plan = tr.now()
            buckets0 = metrics.buckets
        if not plan:
            break
        metrics.levels += 1
        metrics.candidates += n_cands
        frequent = []
        level: List[Tuple[Itemset, int]] = []
        if delta is None:
            # the collectors threshold the level themselves unless the
            # cluster exchange needs every pair
            floor = min_support if cluster is None else 0
            swept, collect = _spawn_sweeps(plan, None)
            if tr is not None:
                tr.span("plan", t_plan, cat=HOST_CAT,
                        args={"candidates": n_cands,
                              "buckets": metrics.buckets - buckets0,
                              "tuples": len(level)})
            if cluster is None:
                sched.wait_all()
            else:
                cluster.level_wait(sched)
            t_collect = tr.now() if tr is not None else 0.0
            if df_miner is not None:
                _raise_task_errors(detached_tasks)
                df_miner.raise_errors()
            level = _threshold(swept, collect(), floor)
            built = len(level)
            if cluster is None:
                counted = sum(len(b.exts) for b in swept)
            else:
                level = cluster.exchange(level)
                counted = len(level)
        else:
            # classify by masks, sweep the dirty and fresh sub-buckets,
            # fold their counts into the known store a bucket at a time
            # and threshold every bucket from it: a tuple is built only
            # for a frequent candidate
            classified, n_clean, dirty, fresh = delta.classify_buckets(plan)
            n_dirty = sum(len(b.exts) for b in dirty)
            n_fresh = sum(len(b.exts) for b in fresh)
            if cluster is None or cluster.host_id == 0:
                # loopback hosts share the plan: bill its avoided-work
                # counters once, not once per host
                delta.reused += n_clean
                delta.swept_full += n_fresh
                delta.swept_delta += n_dirty
            if cluster is not None:
                dirty = [b for b in dirty if cluster.owns(b.prefix)]
            fresh, collect_fresh = _spawn_sweeps(fresh, delta.base_segments)
            collect_dirty = _spawn_delta_chunks(dirty)
            if tr is not None:
                tr.span("plan", t_plan, cat=HOST_CAT,
                        args={"candidates": n_cands,
                              "buckets": metrics.buckets - buckets0,
                              "clean": n_clean, "dirty": n_dirty,
                              "fresh": n_fresh, "tuples": len(level)})
            if cluster is None:
                sched.wait_all()
            else:
                cluster.level_wait(sched)
            t_collect = tr.now() if tr is not None else 0.0
            counts = ([(b, c, True) for b, c in zip(fresh, collect_fresh())]
                      + [(b, c, False)
                         for b, c in zip(dirty, collect_dirty())])
            if cluster is None:
                sups = delta.fold(classified, counts)
            else:
                # the fold runs once per known store (host 0 under
                # loopback, where the hosts share the plan), and every
                # host gets the level's supports back
                sups = cluster.exchange(
                    counts, update=lambda got: delta.fold(classified, got))
            level = delta.threshold(classified, sups, min_support)
            built = len(level)
            counted = n_cands
        for c, s in level:
            if s >= min_support:
                result[c] = s
                frequent.append(c)
        frequent.sort()
        metrics.frequent += len(frequent)
        if tr is not None:
            # in a cluster run this includes the level exchange;
            # ``tuples``: the (itemset, support) pairs the collectors
            # built (with a floor, the frequent ones only)
            tr.span("collect", t_collect, cat=HOST_CAT,
                    args={"candidates": counted,
                          "frequent": len(frequent), "tuples": built})
            # driver-lane level span: the barrier-to-barrier extent
            tr.span(f"level-{k}", t_level, cat="level",
                    args={"candidates": n_cands,
                          "frequent": len(frequent)})
        k += 1


class _ClassMiner:
    """Barrier-free equivalence-class machinery: tasks spawn child
    classes. Shared by ``granularity="depth-first"`` (every root item is
    a class) and ``granularity="auto"`` (the levelwise engine detaches
    model-chosen prefix buckets into class tasks mid-run).

    A task = one equivalence class (P, E) owning an arena handle for P's
    row: it sweeps the |E| extensions through the dispatcher, records
    the frequent extensions, then for each frequent sibling e (except
    the last) makes the child row ONCE in the arena and spawns the child
    class (P+(e,), {frequent siblings > e}) with the new handle. The
    child never recomputes a prefix intersection — the handoff replaces
    the LRU cache entirely. Eclat shape: no global candidate generation,
    no Apriori cross-class prune (supports are identical; a few extra
    infrequent candidates get swept).

    Hybrid representation (``model`` set): the handed row's
    representation is chosen per child by the density cost model —
    dense word-column (``materialize``), sorted tid-list
    (``push_tids``), or dEclat diffset anchored on P (``push_diffset``).
    A sparse P is swept by the gather-intersect path, which returns
    |payload ∩ e| — for a tid-list that IS the support, for a diffset
    the class converts it with the parent-sibling supports handed down
    at spawn (``support = psup[e] - |diff ∩ e|``). Sparse children of a
    sparse parent are carved out of P's explicit tid set
    (``resolve_tids``, reconstructed once per class), so no dense
    intermediate is built.

    On host-parallel backends sparse subtrees run PROJECTED instead: the
    class sweep's [E, S] bit matrix (``sweep_bits``) is the dEclat
    recursion state — a child class receives its sibling rows
    column-masked to its own tid positions, its supports are row sums,
    and no arena row, dispatcher hop or gather exists in the subtree's
    interior. The kernel backend keeps the arena handoff path: rows live
    in the device mirror, and every class sweep is a dispatcher request
    batched into the kernels' launches. Class tasks touch only the host
    store (materialize, carve, resolve); only the dispatcher thread
    touches the device.

    Memory bound: a handed row is live from its creation until the child
    task's ``finally`` releases it (also on a task error — a leaked
    refcount would keep the slot from recycling). With depth-first drain
    order and spawn-onto-own-worker placement, each worker holds
    O(depth × branching) live rows instead of a whole level's worth;
    the arena measures the peak (``metrics.peak_retained_bitmaps``).

    With a ``delta`` plan each class splits its extensions into clean
    known (support looked up, zero rows), dirty known (delta sweep over
    the pending segments only) and fresh (full sweep over the generation
    boundary), and a child subtree is recursed into ONLY when some
    candidate in it is fresh or dirty — a clean subtree's results are
    already exact in ``delta.known``, so whole equivalence classes are
    skipped without touching a row. Diffset children are disabled under
    delta (``allow_diffset=False``): a dirty diffset sweep would need
    |parent ∩ e ∩ pending|, which the delta path does not carry;
    tid-list children delta-sweep fine (the backend cuts the payload to
    the pending segments' tid windows).

    Under a ``cluster`` the root classes partition by owner host, and
    every class sweep names its prefix itemset so the peers can count
    it."""

    def __init__(self, store, dispatchers, min_support, max_k, sched,
                 metrics, result, delta=None, model=None, cluster=None):
        self.store = store
        self.dispatchers = dispatchers          # one per arena shard
        self.min_support = min_support
        self.max_k = max_k
        self.sched = sched
        self.metrics = metrics
        self.result = result
        self.delta = delta
        self.model = model
        self.cluster = cluster
        self.n_w = store.n_words
        self.lock = threading.Lock()
        self.all_tasks: List = []
        self._obs = 0     # observe() sampling counter (racy is fine)

    def needs_visit(self, cprefix: Itemset, csibs) -> bool:
        """A class subtree can contain changed or never-swept itemsets
        only if one of ITS OWN candidates is fresh or dirty: deeper dirt
        implies a dirty candidate here (X ⊆ dirty items ⇒ every
        sub-candidate too), and deeper freshness implies a frequency
        status change here (supports only change where dirt is)."""
        delta = self.delta
        for e in csibs:
            c = cprefix + (e,)
            if delta.known.get(c) is None or delta.is_dirty(c):
                return True
        return False

    def _class_tids(self, ph: int, ptids_hint) -> np.ndarray:
        """P's explicit tid set, resolved once per class. A diffset's
        spawner handed P's parent tid set down, so resolution is ONE
        sorted difference, not a chain walk; a bitmap row is scanned
        (billed as a sparsify)."""
        store = self.store
        rep = store.rep_of(ph)
        if rep == tidlist.REP_DIFFSET:
            if ptids_hint is not None:
                return tidlist.sorted_difference(ptids_hint,
                                                 store.tids_of(ph))
            return store.resolve_tids(ph)
        if rep == tidlist.REP_TIDLIST:
            return store.tids_of(ph)
        return store.resolve_tids(ph)

    def _make_child(self, ph, e, csup, crep, shard, ptids, bits):
        """One child handoff row in the model-picked representation.
        Returns (handle, handoff-bytes-read, is-sparse). ``ptids`` is P's
        explicit tid set and ``bits`` its membership row in ext e, both
        resolved/gathered ONCE per class by the caller; only the
        dense-parent materialize path runs without them."""
        store = self.store
        if crep == "bitmap" and store.rep_of(ph) == tidlist.REP_BITMAP:
            return (store.materialize(ph, e, shard=shard),
                    self.n_w * 4, False)
        cov = min(store.cover_of(ph), store.cover_of(e))
        read = len(ptids) * 4 * 2      # bits gather + payload carve
        if crep == "bitmap":
            # under "auto" a dense child of a sparse parent can't win
            # the cost model (child support ≤ parent support), so this
            # is the forced-densify corner only
            ch = store.push(tidlist.tids_to_bitmap(ptids[bits], self.n_w),
                            shard=shard, cover=cov)
            return ch, read + self.n_w * 4, False
        if crep == "tidlist":
            ch = store.push_tids(ptids[bits], shard=shard, cover=cov)
        else:
            ch = store.push_diffset(ptids[~bits], anchor=ph, support=csup,
                                    shard=shard, cover=cov)
        return ch, read, True

    def class_task(self, prefix: Itemset, ph: int,
                   exts: Tuple[int, ...], psup: Tuple[int, ...],
                   own_support: int, owned: bool,
                   ptids_hint=None, sub=None) -> None:
        store, sched, delta = self.store, self.sched, self.delta
        min_support, model = self.min_support, self.model
        children: List[Tuple[Itemset, int, Tuple[int, ...],
                             Tuple[int, ...], int, object, object]] = []
        try:
            k = len(prefix) + 1                 # size of swept itemsets
            shard = sched.worker_device()
            st = sched.worker_stats()
            disp = self.dispatchers[shard]
            # host backends mine sparse subtrees projected; a projected
            # child is a positional tid mask whose sweep reads its bools
            # however it was notionally encoded, so a diffset's smaller
            # size buys nothing there and the model must not price it
            host = delta is None and disp.backend.host_parallel
            pbits = None      # the sweep's own [E, S] payload∩ext matrix
            fresh_e: List[int] = []
            dirty_e: List[int] = []
            if sub is not None:
                # projected class: ``sub`` is the subtree root's bit
                # matrix, row-selected to this class's extensions and
                # column-sliced to its tid positions — no arena row
                # exists for P at all
                rep = None
                sparse = True
                is_diff = False
                payload = sub.shape[1]
                # support of P+e is a masked row sum
                counts = sub.sum(axis=1, dtype=np.int64)
                pbits = sub
                supports = [(e, int(s)) for e, s in zip(exts, counts)]
            else:
                rep = store.rep_of(ph)
                sparse = rep != tidlist.REP_BITMAP
                payload = len(store.tids_of(ph)) if sparse else 0
                is_diff = rep == tidlist.REP_DIFFSET
            if sub is None and delta is None:
                st.sweeps_submitted += 1
                counts, pbits = disp.sweep_bits(ph, exts, desc=prefix)
                if is_diff:
                    # dEclat arithmetic: the backend counted |diff ∩ e|;
                    # the parent's sibling supports turn it into support
                    supports = [(e, psup[j] - int(s)) for j, (e, s)
                                in enumerate(zip(exts, counts))]
                else:
                    supports = [(e, int(s)) for e, s in zip(exts, counts)]
            elif delta is not None:
                supports = []
                for e in exts:
                    c = prefix + (e,)
                    ks = delta.known.get(c)
                    if ks is None:
                        fresh_e.append(e)
                    elif delta.is_dirty(c):
                        dirty_e.append(e)
                    else:
                        supports.append((e, ks))    # clean: zero rows
                n_clean = len(supports)
                # both sweeps go out before either result is awaited, so
                # they share a dispatcher flush; fresh sweeps read the
                # generation-boundary segments, never ones an overlapped
                # ingest appended mid-refresh
                ffut = (disp.submit(ph, tuple(fresh_e),
                                    segments=delta.base_segments,
                                    desc=prefix)
                        if fresh_e else None)
                dfut = (disp.submit(ph, tuple(dirty_e),
                                    segments=delta.segments, desc=prefix)
                        if dirty_e else None)
                updates: Dict[Itemset, int] = {}
                if ffut is not None:
                    st.sweeps_submitted += 1
                    for e, s in zip(fresh_e, ffut.result()):
                        updates[prefix + (e,)] = int(s)
                        supports.append((e, int(s)))
                if dfut is not None:
                    st.sweeps_submitted += 1
                    for e, d in zip(dirty_e, dfut.result()):
                        c = prefix + (e,)
                        s = delta.known[c] + int(d)
                        updates[c] = s
                        supports.append((e, s))
                with delta.lock:
                    delta.known.update(updates)
                    delta.mark_swept(prefix, fresh_e + dirty_e)
                    delta.swept_full += len(fresh_e)
                    delta.swept_delta += len(dirty_e)
                    delta.reused += n_clean
                supports.sort()       # merged lists back to ext order
            swept = len(fresh_e) + len(dirty_e)
            if model is not None and supports:
                # sampled EWMA: the gauge steers granularity detach
                # decisions, not per-child picks — every 4th class is
                # plenty of signal and trims the per-class Python floor
                self._obs += 1
                if (self._obs & 3) == 0:
                    model.observe([s for _, s in supports])
            freq = [(e, s) for e, s in supports if s >= min_support]
            sibs = [e for e, _ in freq]         # ascending (exts sorted)
            child_bytes = 0
            child_sparse_bytes = 0
            if k < self.max_k and len(freq) > 1:
                # pick every child's representation first, so the carve
                # work (P's explicit tid set + its membership bits in
                # each child ext) resolves and gathers ONCE per class
                plan = [(i, e, csup,
                         "bitmap" if model is None
                         else model.pick_child_rep(
                             own_support, csup,
                             allow_diffset=delta is None and not host))
                        for i, (e, csup) in enumerate(freq[:-1])
                        # a clean subtree's supports are exact in known
                        if delta is None or self.needs_visit(
                            prefix + (e,), tuple(sibs[i + 1:]))]
                # host backends mine sparse subtrees PROJECTED: the
                # sweep's bit matrix, row-selected to the frequent
                # siblings, IS the dEclat recursion state. The kernel
                # backend keeps arena handoffs (the device owns the
                # rows; projection would drag every class to the host).
                proj = host and (sparse
                                 or any(p[3] != "bitmap" for p in plan))
                fmat = None   # frequent-sibling bits over P's tid set
                ptids = None  # P's tid set, resolved at most once
                bcol: Dict[int, int] = {}   # ext -> row in bit matrix
                bmat = None
                if proj and plan:
                    if pbits is not None and not is_diff:
                        eidx = {e: j for j, e in enumerate(exts)}
                        fmat = pbits[[eidx[f] for f in sibs]]
                    else:
                        ptids = self._class_tids(ph, ptids_hint)
                        fmat = store.gather_bits_rows(ptids, sibs)
                        child_bytes += len(ptids) * 4
                elif plan and not host:
                    carve = [p for p in plan
                             if p[3] != "bitmap"
                             or rep != tidlist.REP_BITMAP]
                    if carve:
                        ptids = self._class_tids(ph, ptids_hint)
                        if is_diff:
                            pbits = None  # sweep bits were over diff
                        if pbits is not None:
                            eidx = {e: j for j, e in enumerate(exts)}
                            bcol = {e: eidx[e] for _, e, _, _ in carve}
                            bmat = pbits
                        else:
                            ce = [e for _, e, _, _ in carve]
                            bmat = store.gather_bits_rows(ptids, ce)
                            bcol = {e: j for j, e in enumerate(ce)}
                for i, e, csup, crep in plan:
                    if proj and (crep != "bitmap" or sparse):
                        m = fmat[i]
                        csub = fmat[i + 1:len(freq)][:, m]
                        read = csub.nbytes + m.nbytes
                        child_bytes += read
                        child_sparse_bytes += read
                        children.append((prefix + (e,), -1,
                                         tuple(sibs[i + 1:]),
                                         tuple(s for _, s in freq[i + 1:]),
                                         csup, None, csub))
                        continue
                    ch, read, ch_sparse = self._make_child(
                        ph, e, csup, crep, shard, ptids,
                        bmat[bcol[e]] if e in bcol else None)
                    child_bytes += read
                    if ch_sparse:
                        child_sparse_bytes += read
                    children.append((prefix + (e,), ch,
                                     tuple(sibs[i + 1:]),
                                     tuple(s for _, s in freq[i + 1:]),
                                     csup,
                                     ptids if crep == "diffset" else None,
                                     None))
            if delta is None:
                rows = class_rows_touched(len(exts), len(children))
                st.rows_touched += rows
                if sparse:
                    # gather-intersect passes: the payload once per
                    # extension (plus once for itself), never W words —
                    # plus the measured child-handoff reads. Projected
                    # classes read exactly their bit matrix.
                    sb = (sub.nbytes if sub is not None
                          else payload * 4 * (1 + len(exts)))
                    st.bytes_swept += sb + child_bytes
                    st.sparse_bytes_swept += sb + child_sparse_bytes
                else:
                    st.bytes_swept += rows_to_bytes(rows, self.n_w)
                    st.sparse_bytes_swept += child_sparse_bytes
            else:
                # only what was read: the handed prefix row (when any
                # sweep ran), swept extension rows (dirty ones only over
                # the pending segments' words) and child handoffs
                seg_w = sum(store.seg_words(g) for g in delta.segments)
                full_rows = ((1 if swept else 0) + len(fresh_e)
                             + len(children))
                st.rows_touched += full_rows + len(dirty_e)
                if sparse:
                    sb = (payload * 4 * (1 + len(fresh_e) + len(dirty_e))
                          + child_bytes)
                    st.bytes_swept += sb
                    st.sparse_bytes_swept += sb
                else:
                    st.bytes_swept += (rows_to_bytes(full_rows, self.n_w)
                                       + rows_to_bytes(len(dirty_e), seg_w))
                    st.sparse_bytes_swept += child_sparse_bytes
            if swept or delta is None:
                if sparse:
                    st.sparse_sweeps += 1
                else:
                    st.dense_sweeps += 1
            with self.lock:
                metrics = self.metrics
                metrics.buckets += 1
                metrics.candidates += len(exts)
                metrics.levels = max(metrics.levels, k - 1)
                metrics.frequent += len(freq)
                for e, s in freq:
                    self.result[prefix + (e,)] = s
            spawned = []
            while children:
                (cprefix, ch, csibs, cpsup, csup, chint,
                 csub) = children[0]
                spawned.append(self.spawn(cprefix, ch, csibs, cpsup, csup,
                                          csub is None, chint, csub))
                children.pop(0)       # ownership moved to the child task
            if spawned:
                with self.lock:
                    self.all_tasks.extend(spawned)
        except BaseException:
            # refcount hygiene on error: handoff rows whose child tasks
            # never spawned must release here or they leak for the rest
            # of the run (projected children own nothing — their state
            # is the sliced bit matrix)
            for _, ch, _, _, _, _, csub in children:
                if csub is None:
                    store.release(ch)
            raise
        finally:
            if owned:
                store.release(ph)

    def spawn(self, prefix: Itemset, ph: int, exts, psup,
              own_support: int, owned: bool, ptids_hint=None, sub=None):
        delta = self.delta
        return self.sched.spawn(
            self.class_task, prefix, ph, exts, psup, own_support, owned,
            ptids_hint, sub, attr=(itemset_hash(prefix), prefix),
            depth=len(prefix),
            priority=(delta.priority_of(prefix)
                      if delta is not None and delta.priority_of else 0.0),
            tenant=delta.tenant if delta is not None else None,
            handles=(ph,) if owned else ())

    def spawn_roots(self, frequent, result) -> None:
        """One class per root item (the depth-first engine). Root
        classes hand the pinned base row's handle (== item id — nothing
        materialized, nothing retained); their sibling supports are the
        level-1 supports."""
        if self.max_k < 2 or len(frequent) < 2:
            return
        items = [p[0] for p in frequent]        # sorted singleton items
        sup = {p[0]: result[p] for p in frequent}
        for i, it in enumerate(items[:-1]):
            sibs = tuple(items[i + 1:])
            if self.cluster is not None and not self.cluster.owns((it,)):
                continue              # a peer host mines this subtree
            if self.delta is not None and not self.needs_visit((it,), sibs):
                continue              # clean root class: skip entirely
            t = self.spawn((it,), it, sibs, tuple(sup[e] for e in sibs),
                           sup[it], False)
            with self.lock:   # already-running roots append concurrently
                self.all_tasks.append(t)

    def raise_errors(self) -> None:
        """Raise the first error of the class tasks spawned so far, and
        let go of them: a task's body is a bound method of this miner,
        so the kept list would hold the miner, and its arena, in a
        reference cycle."""
        with self.lock:
            tasks, self.all_tasks = self.all_tasks, []
        _raise_task_errors(tasks)


def _mine_depth_first(store, dispatchers, min_support, max_k, sched,
                      metrics, result, frequent, delta=None, model=None,
                      cluster=None):
    """Barrier-free engine: see :class:`_ClassMiner`. Under a cluster the
    root classes partition by owner host (the per-flush reduction makes
    every count global, so each subtree's decisions are host-independent)
    and one terminal exchange replicates the mined itemsets."""
    miner = _ClassMiner(store, dispatchers, min_support, max_k, sched,
                        metrics, result, delta=delta, model=model,
                        cluster=cluster)
    miner.spawn_roots(frequent, result)
    if cluster is None:
        sched.wait_all()                        # the ONLY wait
        miner.raise_errors()
        return
    cluster.level_wait(sched)
    miner.raise_errors()
    mined = [(c, s) for c, s in result.items() if len(c) > 1]
    for c, s in cluster.exchange(mined):
        result[c] = s


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
