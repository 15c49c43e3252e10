"""Streaming ingestion, incremental re-mining and pattern serving.

The batch engine (``repro_torch.core.fpm``) answers "what is frequent in
this database" once; a deployed miner faces a database that keeps
growing and queries that cannot wait for a re-mine. This module closes
that gap on top of the arena, scheduler and dispatcher:

``StreamingMiner.ingest(batch)``
    packs the new transactions into a FRESH arena segment
    (``BitmapArena.add_segment``): per-item word-columns for the new
    transactions only. Existing segments are never repacked, and an
    eagerly mirrored arena (``arena="jax"``) uploads exactly the new
    segment's payload (``seg_nbytes``).

``StreamingMiner.refresh()``
    folds the pending segments in incrementally. Per-item support
    deltas over ONLY the fresh segments classify the *dirty items* (an
    itemset's support can change only if every one of its items occurs
    in the new batch); the engines then re-mine only invalidated
    equivalence classes (``DeltaPlan``): clean known candidates are
    looked up (zero rows), dirty ones are delta-swept over the pending
    segments as tuple-prefix sweeps, and never-seen candidates get full
    sweeps. Re-mine tasks carry a staleness priority (the stale prefix's
    last known support), so the clustered drain rules serve stale-hot
    buckets first. Each publish may fold the refreshed segments back
    into one (compaction).

``PatternServer`` / ``QueryPlanner``
    answer ``support`` / ``top_k`` / ``frequent`` queries. Dict hits
    read the last PUBLISHED generation: every refresh builds an
    immutable ``PatternSnapshot`` (frequent supports and the negative
    border) and swaps it in atomically. An itemset the generation never
    counted is decomposed into a prefix-tuple + extension sweep and
    enqueued as a PRIORITY request on the same live (per-shard)
    dispatchers the refresh uses, so query sweeps coalesce into the
    flushes that carry candidate sweeps. ``top_k`` ranks on the arena's
    device (torch operations) once the snapshot holds
    ``TOPK_DEVICE_MIN`` itemsets.

Correctness anchor: after ANY ingest sequence, ``refresh()`` yields
exactly the frequent itemsets (and supports) of a from-scratch
``fpm.mine`` on the concatenated database, at every granularity and
policy; and ``support_many`` answers equal brute-force counts over the
refreshed prefix of the database.

``StreamingMiner(hosts=N)`` runs the same stream over N word-sliced
host arenas (``repro_torch.core.cluster``), and ``TenantHub`` multiplexes
several tenants' streams onto one arena and one engine runtime. Both
take ``mesh=`` as ``fpm.mine`` does: a sharded arena with one dispatcher
per shard, and query sweeps round-robin over the shards' dispatchers.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from types import MappingProxyType
from typing import Any, Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core import cluster as _cluster
from repro_torch.core import tidlist
from repro_torch.core.fpm import (HOST_CAT, DeltaPlan, EngineRuntime,
                                  MiningMetrics, MiningRun, _resolve_mesh,
                                  mine_more)
from repro_torch.core.itemsets import Itemset
from repro_torch.core.join_backend import FLUSH_US, MAX_BATCH
from repro_torch.core.known import BorderView, KnownStore
from repro_torch.core.scheduler import ClusteredPolicy
from repro_torch.core.tidlist import (BitmapArena, pack_database,
                                      resolve_device)
from repro_torch.obs import LatencyRecorder, MetricsRegistry
from repro_torch.obs import schema as obs_schema
from repro_torch.obs.tracer import with_gc_spans

# ---------------------------------------------------------------------------
# device-resident top-k
# ---------------------------------------------------------------------------

# snapshots below this many itemsets rank faster with one numpy argsort
# than with a device round trip (the reference's policy); tests patch it
# to 0 to force the device path on tiny inputs
TOPK_DEVICE_MIN = 4096


class _SnapshotIndex:
    """Flat itemset encodings for vectorized ``top_k``: rows sorted
    lexicographically, items right-padded with -1. Ranking by support
    descending with ties to the smaller row reproduces the serving
    tie-break (equal supports rank lexicographically). The host path
    gets that order from numpy's stable argsort; the device path ranks
    on a unique int64 key (below), so the two are bit-identical."""

    def __init__(self, supports: Mapping[Itemset, int],
                 device: "torch.device | str | None"):
        items = sorted(supports)
        n = len(items)
        kmax = max((len(x) for x in items), default=1)
        enc = np.full((n, kmax), -1, np.int32)
        lens = np.zeros(n, np.int32)
        sup = np.zeros(n, np.int64)
        for r, x in enumerate(items):
            enc[r, :len(x)] = x
            lens[r] = len(x)
            sup[r] = supports[x]
        self.items = items
        self.enc, self.lens, self.sup = enc, lens, sup
        self.device = device
        self._dev = None      # device copies, uploaded on first use

    def top_k(self, prefix: Itemset, k: int) -> List[Tuple[Itemset, int]]:
        plen = len(prefix)
        n = len(self.items)
        if n == 0 or k <= 0 or plen >= self.enc.shape[1]:
            return []
        if n >= TOPK_DEVICE_MIN:
            order, vals = self._device_top_k(prefix, k)
        else:
            mask = self.lens > plen
            if plen:
                mask &= (self.enc[:, :plen]
                         == np.asarray(prefix, np.int32)).all(axis=1)
            scored = np.where(mask, self.sup, -1)
            order = np.argsort(-scored, kind="stable")[:k]
            vals = scored[order]
        return [(self.items[int(r)], int(v))
                for r, v in zip(order, vals) if v >= 0]

    def _device_top_k(self, prefix: Itemset, k: int):
        """The masked top-k on the device: rows longer than the prefix
        whose leading items equal it keep their support, the rest score
        -1. ``torch.topk`` documents no order among equal values, so it
        ranks the unique key ``score * n + (n - 1 - row)`` — support
        first, then the smaller row — and the result is the host's
        stable order exactly."""
        if self._dev is None:
            dev = resolve_device(self.device)
            n = len(self.items)
            self._dev = (torch.from_numpy(self.enc).to(dev),
                         torch.from_numpy(self.lens).to(dev),
                         torch.from_numpy(self.sup).to(dev),
                         torch.arange(n - 1, -1, -1, dtype=torch.int64,
                                      device=dev))
        enc, lens, sup, tiebreak = self._dev
        n, plen = enc.shape[0], len(prefix)
        match = lens > plen
        if plen:
            pref = torch.tensor(prefix, dtype=torch.int32,
                                device=enc.device)
            match &= (enc[:, :plen] == pref).all(dim=1)
        scored = torch.where(match, sup, -1)
        _, idx = torch.topk(scored * n + tiebreak, min(k, n))
        return idx.cpu().numpy(), scored[idx].cpu().numpy()


# ---------------------------------------------------------------------------
# snapshots + serving
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PatternSnapshot:
    """One published generation of mining results — immutable, so a
    reader holding it can answer any number of queries consistently
    while newer generations are mined and swapped in behind it.

    ``supports`` maps every frequent itemset (singletons included) to
    its exact support over the ``n_transactions`` the generation covers;
    ``border`` maps the NEGATIVE border — candidates the engines counted
    whose support landed below ``min_support`` — to those exact
    sub-threshold supports (:meth:`lookup` flags them infrequent); a
    refresh publishes it as a read-only view over its known store's
    arrays (``BorderView``), kept as it is. The
    ranking index for ``top_k`` is built on the first ranked query, and
    ranks on ``device`` (None = the CUDA card) once it is large enough
    (``TOPK_DEVICE_MIN``). A racing build is benign: both threads build
    the identical index and the reference store is atomic."""
    generation: int
    n_transactions: int
    min_support: int
    supports: Mapping[Itemset, int]
    border: Mapping[Itemset, int] = field(default_factory=dict)
    device: "torch.device | str | None" = None

    def __post_init__(self):
        object.__setattr__(self, "supports",
                           MappingProxyType(dict(self.supports)))
        if not isinstance(self.border, BorderView):
            object.__setattr__(self, "border",
                               MappingProxyType(dict(self.border)))
        object.__setattr__(self, "_index_cache", None)

    @property
    def _index(self) -> _SnapshotIndex:
        idx = self._index_cache
        if idx is None:
            idx = _SnapshotIndex(self.supports, self.device)
            object.__setattr__(self, "_index_cache", idx)
        return idx

    def support(self, itemset: Sequence[int],
                include_infrequent: bool = False) -> Optional[int]:
        """Exact support of a FREQUENT itemset; None if it was not
        frequent at this generation. With ``include_infrequent`` the
        negative border answers too; None then means never counted."""
        x = tuple(sorted(itemset))
        s = self.supports.get(x)
        if s is None and include_infrequent:
            s = self.border.get(x)
        return s

    def lookup(self, itemset: Sequence[int]) -> Optional[Tuple[int, bool]]:
        """``(support, infrequent)`` for anything this generation
        counted — frequent or negative border — else None."""
        x = tuple(sorted(itemset))
        s = self.supports.get(x)
        if s is not None:
            return s, False
        s = self.border.get(x)
        if s is not None:
            return s, True
        return None

    def top_k(self, prefix: Sequence[int] = (), k: int = 10
              ) -> List[Tuple[Itemset, int]]:
        """The k highest-support frequent itemsets strictly extending
        ``prefix`` (itemsets whose leading items equal it), best first;
        ties rank lexicographically. ``prefix=()`` ranks everything."""
        return self._index.top_k(tuple(sorted(prefix)), k)

    def frequent(self, min_support: Optional[int] = None
                 ) -> Dict[Itemset, int]:
        """All frequent itemsets, optionally re-thresholded UPWARD
        (supports below this generation's threshold were never
        published, so a lower one cannot be answered)."""
        if min_support is None or min_support <= self.min_support:
            return dict(self.supports)
        return {x: s for x, s in self.supports.items() if s >= min_support}


class QueryPlanner:
    """Decomposes a batch of support queries against ONE captured
    generation — snapshot, known store, singleton supports and the
    segment set they cover, all read under the owner's state lock, so
    every answer in the batch is consistent with that generation.

    The empty itemset is the transaction count, singletons read the
    item-support vector, and any |X| >= 2 itemset already counted
    (published, negative border, or an earlier query's backfill) answers
    from the known store. The rest become prefix-tuple + extension
    sweeps ``(x[:-1], (x[-1],))`` — the backend ANDs the k-1 prefix rows
    per segment and popcounts the intersection with the last item's row:
    exactly a candidate sweep's shape, so query and candidate requests
    coalesce into the same flushes."""

    def __init__(self, snapshot: PatternSnapshot, known: KnownStore,
                 item_support: np.ndarray, segments: Sequence[int]):
        self.snapshot = snapshot
        self.known = known
        self.item_support = item_support
        self.segments = tuple(segments)

    def plan(self, itemsets: Sequence[Itemset]):
        """``(answers, sweeps, slots)``: ``answers[i]`` is a ``(support,
        swept)`` pair for dict-answerable queries and None otherwise;
        ``sweeps[j]`` is the ``(prefix, exts)`` request answering
        ``itemsets[slots[j]]``."""
        answers: List[Optional[Tuple[int, bool]]] = [None] * len(itemsets)
        sweeps: List[Tuple[Any, Tuple[int, ...]]] = []
        slots: List[int] = []
        for j, x in enumerate(itemsets):
            if not x:
                answers[j] = (int(self.snapshot.n_transactions), False)
            elif len(x) == 1:
                answers[j] = (int(self.item_support[x[0]]), False)
            else:
                s = self.known.get(x)
                if s is not None:
                    answers[j] = (int(s), False)
                else:
                    sweeps.append((x[0] if len(x) == 2 else x[:-1],
                                   (x[-1],)))
                    slots.append(j)
        return answers, sweeps, slots


class _QueryGate:
    """Counts in-flight query sweeps against one state lock, so
    compaction — which renumbers the segment ids those sweeps hold — can
    wait for them to land. ``begin`` requires the lock held; ``end``
    takes it itself; ``wait_idle`` (lock held) releases it while
    waiting."""

    def __init__(self, lock):
        self.cv = threading.Condition(lock)
        self.inflight = 0

    def begin(self) -> None:
        self.inflight += 1

    def end(self) -> None:
        with self.cv:
            self.inflight -= 1
            if not self.inflight:
                self.cv.notify_all()

    def wait_idle(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while self.inflight:
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            self.cv.wait(left)
        return True


def _serve_queries(owner, itemsets: Sequence[Sequence[int]]
                   ) -> List[Tuple[int, bool]]:
    """The serving path: plan under the state lock, sweep the misses as
    one priority burst on the runtime's dispatcher, backfill the known
    store, and return ``(support, swept)`` per itemset."""
    t_q = time.perf_counter()
    xs: List[Itemset] = []
    for raw in itemsets:
        x = tuple(sorted({int(i) for i in raw}))
        for i in x:
            if not 0 <= i < owner.n_items:
                raise ValueError(f"item id {i} outside [0, {owner.n_items})")
        xs.append(x)
    with owner._state:
        planner = owner._query_view()
        answers, sweeps, slots = planner.plan(xs)
        if slots:
            runtime = owner._ensure_runtime()
            known_ref = planner.known
            owner._gate.begin()
    if not slots:
        # pure snapshot hits: per-query share of the batched call
        owner.latency.record(
            "hit", (time.perf_counter() - t_q) / max(len(xs), 1), n=len(xs))
        return answers
    try:
        # priority requests on the live per-shard dispatchers, in turn
        disp = runtime.dispatchers[
            next(owner._q_rr) % len(runtime.dispatchers)]
        futs = disp.submit_many(sweeps, segments=planner.segments,
                                priority=True)
        counts = [int(f.result()[0]) for f in futs]
    finally:
        owner._gate.end()
    seg_words = sum(owner.arena.seg_words(g) for g in planner.segments)
    nbytes = sum((len(p) if isinstance(p, tuple) else 1) + 1
                 for p, _ in sweeps) * seg_words * 4
    updates: Dict[Itemset, int] = {}
    for j, c in zip(slots, counts):
        answers[j] = (c, True)
        updates[xs[j]] = c
    owner._commit_answers(known_ref, updates)
    owner._bill_query(len(slots), nbytes)
    owner.latency.record(
        "sweep", (time.perf_counter() - t_q) / max(len(xs), 1), n=len(xs))
    return answers


class _Counter:
    """A thread-safe counter: ``self.n += 1`` is a read-modify-write
    that concurrent servers would lose increments to."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def add(self) -> None:
        with self._lock:
            self.value += 1


class PatternServer:
    """Query layer over a :class:`StreamingMiner` (anything that
    publishes a ``snapshot`` and answers ``query_supports``).

    ``support`` is TOTAL and exact: itemsets the published generation
    counted (frequent or negative border) are dict hits on the
    snapshot's backing store; anything never counted is answered by a
    priority sweep through the live dispatcher and backfilled, so a
    repeat of the same query is a dict hit. ``support_many`` amortizes
    planning and coalesces every miss into one burst. Per-kind served
    counters (``hit`` / ``sweep`` / ``top_k``) are thread-safe."""

    def __init__(self, miner):
        self._miner = miner
        self._n = {"hit": _Counter(), "sweep": _Counter(),
                   "top_k": _Counter()}

    @property
    def snapshot(self) -> PatternSnapshot:
        return self._miner.snapshot

    def support(self, itemset: Sequence[int]) -> int:
        """Exact support of ANY itemset over the refreshed database."""
        return self.support_many([itemset])[0]

    def support_many(self, itemsets: Sequence[Sequence[int]]) -> List[int]:
        answers = self._miner.query_supports(itemsets)
        for _, swept in answers:
            self._n["sweep" if swept else "hit"].add()
        return [s for s, _ in answers]

    def top_k(self, prefix: Sequence[int] = (), k: int = 10
              ) -> List[Tuple[Itemset, int]]:
        self._n["top_k"].add()
        t0 = time.perf_counter()
        out = self.snapshot.top_k(prefix, k)
        rec = getattr(self._miner, "latency", None)
        if rec is not None:
            rec.record("top_k", time.perf_counter() - t0)
        return out

    def frequent(self, min_support: Optional[int] = None
                 ) -> Dict[Itemset, int]:
        self._n["hit"].add()
        return self.snapshot.frequent(min_support)

    @property
    def queries(self) -> int:
        """Total served queries (sum of the per-kind counters)."""
        return sum(c.value for c in self._n.values())

    def merged_stats(self) -> Dict[str, int]:
        """Per-kind query counters on the ``repro_torch.obs.schema``
        query schema (``queries`` is the derived sum)."""
        return obs_schema.query_stats({k: c.value
                                       for k, c in self._n.items()})

    def latency_percentiles(self) -> Dict[str, Dict[str, float]]:
        """Exact per-kind p50/p95/p99 from the miner's
        :class:`repro_torch.obs.LatencyRecorder` (empty if absent)."""
        rec = getattr(self._miner, "latency", None)
        return rec.percentiles() if rec is not None else {}


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

@dataclass
class IngestReport:
    segment: int              # arena segment id the batch landed in
    n_transactions: int       # transactions in the batch
    words: int                # packed words per item row (W_seg)
    payload_bytes: int        # the segment's base-bitmap payload
    h2d_bytes: int            # device upload billed by the ingest
                              # (== payload_bytes with eager backing,
                              # 0 when mirrors sync lazily at refresh)
    wall_s: float = 0.0


@dataclass
class RefreshReport:
    generation: int           # the generation this refresh published
    n_transactions: int
    min_support: int
    frequent: int             # published frequent itemsets
    segments_refreshed: Tuple[int, ...]
    dirty_items: int          # items occurring in the fresh segments
    # border classification vs the previous generation
    stayed: int
    born: int
    died: int
    # how much re-mining the delta plan avoided
    reused: int               # candidates answered from known supports
    swept_delta: int          # candidates delta-swept (fresh segments)
    swept_full: int           # candidates fully swept (never seen)
    rows_touched: int
    bytes_swept: int
    h2d_bytes: int            # arena gauge deltas for THIS refresh
    d2d_bytes: int
    wall_s: float = 0.0
    # post-publish segment compaction (0 when the policy didn't fire)
    compacted_segments: int = 0
    compaction_bytes: int = 0
    metrics: Optional[MiningMetrics] = None


def _check_items(db, n_items: int) -> None:
    for txn in db:
        for i in txn:
            if not 0 <= i < n_items:
                raise ValueError(f"item id {i} outside [0, {n_items})")


# ---------------------------------------------------------------------------
# the streaming miner
# ---------------------------------------------------------------------------

def _assemble(owner, known: KnownStore, singles: Dict[Itemset, int],
              ms: int, n_transactions: int, tr
              ) -> Tuple[PatternSnapshot, int]:
    """The generation a refresh of ``owner`` publishes, assembled exactly
    from the known store: skipped (clean) subtrees never touched the
    run's result, but their supports are in the store, and downward
    closure makes the filter exact. The sub-threshold remainder IS the
    negative border, published as a view over the store's arrays.
    Returns the snapshot and how many of its itemsets the previous
    generation held; traced as an ``assemble`` span, whose ``tuples``
    counts the itemsets materialised (the border's are built on
    read)."""
    t_asm = tr.now() if tr is not None else 0.0
    final = dict(singles)
    found, border = known.split(ms, owner.max_k)
    final.update(found)
    prev = owner._snapshot.supports
    stayed = sum(1 for x in final if x in prev)
    snapshot = PatternSnapshot(owner.generation + 1, n_transactions, ms,
                               final, border=border, device=owner.device)
    if tr is not None:
        tr.span("assemble", t_asm, cat=HOST_CAT,
                args={"frequent": len(final), "border": len(border),
                      "tuples": len(final)})
    return snapshot, stayed


def _drop_unswept(plan: DeltaPlan, tr) -> None:
    """``plan.drop_unswept()``, traced as a ``drop-unswept`` span on the
    refreshing thread's lane."""
    if tr is None:
        plan.drop_unswept()
        return
    t0, n0 = tr.now(), len(plan.known)
    plan.drop_unswept()
    tr.span("drop-unswept", t0, cat=HOST_CAT,
            args={"known": n0, "dropped": n0 - len(plan.known)})


class StreamingMiner:
    """Owns one growing, segmented :class:`BitmapArena` and publishes
    mining generations over it.

    ``min_support`` is either an absolute count (held fixed as the
    database grows — supports only grow under ingest, so nothing ever
    dies) or a float fraction of the current transaction count
    (re-resolved at every refresh — it rises with the database, so
    border itemsets can die). ``device`` is where the arena's mirrors
    live, the kernels run and ``top_k`` ranks: None means the CUDA card
    and raises ``RuntimeError`` when there is none; ``"cpu"`` runs the
    kernels' plain versions on the host.

    Engine substrate: ONE persistent :class:`EngineRuntime` (scheduler
    workers and the sweep dispatcher), created on the first refresh or
    query sweep and lent to every refresh's :class:`MiningRun` — so query
    sweeps submitted between (and during) refreshes coalesce into the
    same dispatcher flushes as candidate sweeps. ``close`` tears it
    down.

    Locking: refreshes serialize on ``_refresh_lock``; quick state
    mutations (segment appends, counter/snapshot commits, compaction)
    serialize on ``_state``. An ``ingest`` therefore never blocks behind
    an in-flight ``refresh``: the refresh captures its generation
    boundary (segment count) up front and sweeps only boundary segments,
    and the mid-refresh batch lands in the next generation. Snapshot
    queries take no lock; query SWEEPS register with a gate so
    compaction (which renumbers segments) waits for them. Until the first
    ``refresh`` the published snapshot is the empty generation 0.

    Segment compaction (LSM-style): every publish may fold the refreshed
    segments back into one — ``compact_segments`` is the cadence bound
    (more refreshed segments than this always compacts) and
    ``compact_ratio`` the size bound (a tail at most this fraction of
    the lead segment's width folds at once). The repack bytes are billed
    in the arena's ``compaction_bytes`` and reported per refresh. Set
    ``compact_ratio=0.0`` and a huge ``compact_segments`` to disable.

    Multi-host (``hosts > 1``, loopback): the initial database is
    word-partitioned into one local arena per logical host, each on
    ``device``; each ``ingest`` routes its whole segment to the
    least-loaded host and appends ZERO-WIDTH twins on the peers, so
    segment ids stay globally aligned and refresh deltas are host-local
    by construction. A refresh drives one engine per host over ONE
    shared :class:`DeltaPlan` (the per-flush reduction keeps supports
    global; idle hosts steal whole buckets from busy peers, billed to
    ``steal_net``); queries serve through host 0's runtime, whose
    dispatcher reduction covers the peers. Compaction is off: it would
    have to renumber every host's segments in lockstep. Such a miner
    pins ``representation="bitmap"`` and takes no ``mesh``.

    ``mesh`` accepts what ``fpm.mine`` does: None, an int (logical
    shards on ``device``) or a list of ``torch.device``. The arena is
    then sharded, the runtime has one dispatcher per shard, and query
    sweeps go to the shards' dispatchers in turn."""

    def __init__(self, n_items: int, min_support, *,
                 initial_db: Sequence[Sequence[int]] = (),
                 device: "torch.device | str | None" = None,
                 policy: str = "clustered", n_workers: int = 4,
                 max_k: int = 6, granularity: str = "bucket",
                 backend: str = "auto", arena: str = "auto",
                 cache_size: int = 32, max_batch: int = MAX_BATCH,
                 flush_us: float = FLUSH_US, mesh=None,
                 representation: str = "auto",
                 compact_segments: int = 8,
                 compact_ratio: float = 0.5,
                 hosts: int = 1, tracer=None):
        if n_items < 1:
            raise ValueError(f"n_items must be >= 1, got {n_items}")
        if hosts > 1:
            if mesh is not None:
                raise ValueError("hosts= and mesh= are mutually "
                                 "exclusive")
            if representation not in ("auto", "bitmap"):
                raise ValueError(
                    "hosts > 1 requires representation='bitmap' (sparse "
                    "payloads are positional in one host's slice)")
            representation = "bitmap"
        self._hosts = max(1, int(hosts))
        self.device = resolve_device(device)
        self.n_items = n_items
        self.max_k = max_k
        self._ms_spec = min_support
        # observability: optional tracer threaded into the runtime; the
        # latency recorder is always on (one lock + append per batch)
        self.tracer = tracer
        self.latency = LatencyRecorder()
        # perf_counter of each pending (un-refreshed) segment's ingest,
        # FIFO — refresh_lag reads the head
        self._pending_since: List[float] = []
        self._run_kw = dict(policy=policy, n_workers=n_workers,
                            granularity=granularity, backend=backend,
                            cache_size=cache_size, max_batch=max_batch,
                            flush_us=flush_us,
                            representation=representation)
        initial_db = [list(t) for t in initial_db]
        _check_items(initial_db, n_items)
        # one packing pass yields the bitmaps AND the per-item counts —
        # the level-1 supports and the density-model seed
        bitmaps, item_counts = pack_database(initial_db, n_items,
                                             return_counts=True)
        self._harenas: Optional[List[BitmapArena]] = None
        if self._hosts > 1:
            self._harenas = _cluster.host_arenas(bitmaps, self._hosts,
                                                 self.device, backing=arena)
            self.arena = self._harenas[0]
            self._bus = _cluster._LoopbackBus(self._hosts, self._harenas,
                                              backend)
            self._hctxs = [_cluster.LoopbackContext(self._bus, h)
                           for h in range(self._hosts)]
        else:
            n_shards, devices = _resolve_mesh(mesh)
            self.arena = BitmapArena.from_bitmaps(
                bitmaps, device=self.device, backing=arena,
                n_shards=n_shards, devices=devices)
        self.n_transactions = len(initial_db)
        self._seg_tx = [len(initial_db)]   # transactions per segment
        self._item_support = item_counts
        # support of every candidate ever swept (|X| >= 2; frequent AND
        # negative border), exact over the refreshed segments — the
        # reuse store that lets clean classes skip their sweeps
        self._known = KnownStore()
        # known entries written by query backfills (not by mining): the
        # delta plan only revisits the candidate frontier, so at refresh
        # the dirty ones among these are dropped rather than go stale
        self._query_known: Set[Itemset] = set()
        self._refreshed_segments = self.arena.n_segments
        self.generation = 0
        self.compact_segments = compact_segments
        self.compact_ratio = compact_ratio
        self._state = threading.RLock()     # quick mutations + commits
        self._refresh_lock = threading.Lock()   # one refresh at a time
        self._gate = _QueryGate(self._state)
        self._runtime: Optional[EngineRuntime] = None
        self._hruntimes: Optional[List[EngineRuntime]] = None
        self._q_rr = itertools.count()      # query dispatcher round-robin
        self.query_sweeps = 0
        self.query_sweep_bytes = 0
        self._snapshot = PatternSnapshot(0, self.n_transactions,
                                         self._resolve_ms(), {},
                                         device=self.device)

    # ------------------------------------------------------------ runtime --
    def _new_runtime(self, arena: BitmapArena, cluster=None
                     ) -> EngineRuntime:
        kw = self._run_kw
        return EngineRuntime(
            arena, policy=kw["policy"], n_workers=kw["n_workers"],
            granularity=kw["granularity"], backend=kw["backend"],
            max_batch=kw["max_batch"], flush_us=kw["flush_us"],
            cluster=cluster, tracer=self.tracer)

    def _ensure_runtime(self) -> EngineRuntime:
        """The persistent engine substrate, created on first use so
        snapshot-only readers never pay for worker threads (with hosts,
        one runtime per host; host 0's is the one returned)."""
        with self._state:
            if self._runtime is None:
                if self._hosts > 1:
                    self._hruntimes = [
                        self._new_runtime(self._harenas[h], self._hctxs[h])
                        for h in range(self._hosts)]
                    self._bus.scheds = [rt.sched for rt in self._hruntimes]
                    self._bus.install_steal()
                    self._runtime = self._hruntimes[0]
                else:
                    self._runtime = self._new_runtime(self.arena)
            return self._runtime

    @property
    def runtime(self) -> EngineRuntime:
        """The persistent engine substrate (created on first read)."""
        return self._ensure_runtime()

    def close(self) -> None:
        """Shut down the persistent runtime. Snapshot reads keep working;
        refreshes or query sweeps afterwards start a fresh runtime."""
        with self._state:
            runtime, self._runtime = self._runtime, None
            hosts, self._hruntimes = self._hruntimes, None
        for rt in hosts or ([runtime] if runtime is not None else []):
            rt.shutdown()

    def __enter__(self) -> "StreamingMiner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):   # pragma: no cover - gc-timing dependent
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    # ------------------------------------------------------------ queries --
    @property
    def snapshot(self) -> PatternSnapshot:
        """The last published generation (atomic reference read)."""
        return self._snapshot

    @property
    def needs_refresh(self) -> bool:
        # read both counters under the state lock: a read racing a
        # completing refresh (or a compaction) could pair a fresh
        # segment count with a stale refreshed count
        with self._state:
            return self.arena.n_segments > self._refreshed_segments

    def _resolve_ms(self, n_transactions: Optional[int] = None) -> int:
        if n_transactions is None:
            n_transactions = self.n_transactions
        if isinstance(self._ms_spec, float):
            return max(1, int(self._ms_spec * n_transactions))
        return int(self._ms_spec)

    def _query_view(self) -> QueryPlanner:
        # caller holds _state: snapshot, known store, item supports and
        # the refreshed-segment set are one consistent generation
        return QueryPlanner(self._snapshot, self._known, self._item_support,
                            range(self._refreshed_segments))

    def _commit_answers(self, known_ref: KnownStore,
                        updates: Dict[Itemset, int]) -> None:
        with self._state:
            # a refresh may have published a NEW known store while the
            # sweep was in flight: the answers were exact for the
            # generation they were planned against and go back to the
            # caller, but backfilling them into the new store would
            # corrupt it
            if self._known is known_ref:
                known_ref.update(updates)
                self._query_known.update(updates)

    def _bill_query(self, n_sweeps: int, nbytes: int) -> None:
        with self._state:
            self.query_sweeps += n_sweeps
            self.query_sweep_bytes += nbytes

    def query_supports(self, itemsets: Sequence[Sequence[int]]
                       ) -> List[Tuple[int, bool]]:
        """Exact ``(support, swept)`` for ARBITRARY itemsets over the
        refreshed database — dict hits where the published generation
        already counted, one coalesced priority sweep burst for the rest
        (see :class:`QueryPlanner`)."""
        return _serve_queries(self, itemsets)

    def support_many(self, itemsets: Sequence[Sequence[int]]) -> List[int]:
        """Batched exact supports (``query_supports`` minus the swept
        flags)."""
        return [s for s, _ in self.query_supports(itemsets)]

    # ------------------------------------------------------------- ingest --
    def ingest(self, batch: Sequence[Sequence[int]]) -> IngestReport:
        """Append a batch of transactions as one fresh arena segment.
        O(batch) work and, with eager (``arena="jax"``) backing, exactly
        the new segment's payload in device upload; the mined results
        are stale until the next :meth:`refresh`. Never blocks behind an
        in-flight refresh: the new segment lands in the NEXT
        generation."""
        return with_gc_spans(self.tracer, self._ingest, batch)

    def _ingest(self, batch: Sequence[Sequence[int]]) -> IngestReport:
        batch = [list(t) for t in batch]
        _check_items(batch, self.n_items)
        t0 = time.perf_counter()
        seg_bm = pack_database(batch, self.n_items)   # outside any lock
        with self._state:
            if self._hosts > 1:
                # whole-segment ownership: the least-loaded host gets the
                # payload, every peer a zero-width twin, so segment ids
                # stay aligned across the host arenas and this segment's
                # refresh delta is host-local
                arenas = self._harenas
                owner = min(range(self._hosts),
                            key=lambda h: (arenas[h].n_words, h))
                empty = np.zeros((seg_bm.shape[0], 0), np.uint32)
            else:
                arenas, owner, empty = [self.arena], 0, None
            h0 = sum(ar.h2d_bytes for ar in arenas)
            for h, ar in enumerate(arenas):
                seg = ar.add_segment(seg_bm if h == owner else empty)
            self._seg_tx.append(len(batch))
            self.n_transactions += len(batch)
            self._pending_since.append(t0)
            rep = IngestReport(
                segment=seg, n_transactions=len(batch),
                words=seg_bm.shape[1],
                payload_bytes=arenas[owner].seg_nbytes(seg),
                h2d_bytes=sum(ar.h2d_bytes for ar in arenas) - h0,
                wall_s=time.perf_counter() - t0)
        tr = self.tracer
        if tr is not None:
            tr.span("ingest", t0, cat="stream",
                    args={"segment": rep.segment,
                          "tx": rep.n_transactions,
                          "bytes": rep.payload_bytes})
        return rep

    # ------------------------------------------------------------ refresh --
    def refresh(self, before_publish=None) -> RefreshReport:
        """Fold every pending segment into a new published generation,
        re-mining only invalidated equivalence classes. Returns the
        refresh report; the new :class:`PatternSnapshot` is swapped in
        atomically at the end (``before_publish(snapshot)``, if given,
        runs just before the swap).

        The generation boundary (segment count and transaction count) is
        captured up front under the state lock; every sweep names its
        segments, so batches an overlapped :meth:`ingest` appends
        mid-refresh are invisible to this generation."""
        return with_gc_spans(self.tracer, self._refresh, before_publish)

    def _refresh(self, before_publish) -> RefreshReport:
        tr = self.tracer
        with self._refresh_lock:
            t0 = time.perf_counter()
            arena = self.arena
            with self._state:
                boundary = arena.n_segments
                pending = tuple(range(self._refreshed_segments, boundary))
                boundary_tx = sum(self._seg_tx[:boundary])
                # all-or-nothing: mine against WORKING copies and commit
                # only at publish, so a failed refresh leaves the miner's
                # state untouched and a retry cannot double-add deltas
                # (the store's copy shares its arrays, never written)
                known = self._known.copy()
                qk = set(self._query_known)
            base_segments = tuple(range(boundary))
            t_dirty = tr.now() if tr is not None else 0.0
            deltas = np.zeros(self.n_items, np.int64)
            for g in pending:
                # with hosts a pending segment lives whole on its owner;
                # the peers' zero-width twins add nothing
                for ar in self._harenas or (arena,):
                    seg = ar.seg_view(g)[:self.n_items]
                    if seg.shape[1]:
                        deltas += tidlist.popcount32(seg).sum(axis=1)
            dirty = frozenset(int(i) for i in np.nonzero(deltas)[0])
            if tr is not None:
                tr.span("dirty-items", t_dirty, cat=HOST_CAT,
                        args={"segments": len(pending), "dirty": len(dirty)})
            # query backfills live outside the candidate frontier, so the
            # delta plan is not guaranteed to revisit them — drop the
            # ones whose support may have changed rather than let them
            # serve stale counts; they re-sweep on the next miss
            for x in [x for x in qk if x and all(i in dirty for i in x)]:
                known.pop(x, None)
                qk.discard(x)
            item_support = self._item_support + deltas
            ms = self._resolve_ms(boundary_tx)

            def hotness(prefix: Itemset) -> float:
                """Staleness priority of a re-mine task: the stale
                prefix's popularity (its last known support)."""
                if len(prefix) == 1:
                    return float(item_support[prefix[0]])
                return float(known.get(prefix, 0))

            plan = DeltaPlan(
                known=known, dirty_items=dirty, segments=pending,
                base_segments=base_segments,
                # an empty known store means everything is fresh: no
                # staleness to rank
                priority_of=hotness if known else None)
            singles: Dict[Itemset, int] = {
                (i,): int(s) for i, s in enumerate(item_support) if s >= ms}
            result = dict(singles)
            frequent = sorted(result)
            if self._hosts > 1:
                metrics = self._refresh_cluster(plan, item_support, ms,
                                                singles, t0)
            else:
                h2d0, d2d0 = arena.h2d_bytes, arena.d2d_bytes
                run = MiningRun(arena, item_counts=item_support,
                                runtime=self._ensure_runtime(),
                                **self._run_kw)
                run.metrics.frequent += len(frequent)
                try:
                    mine_more(run, ms, self.max_k, result, frequent,
                              delta=plan)
                finally:
                    run.close()
                metrics = run.finalize(t0)
                metrics.h2d_bytes = arena.h2d_bytes - h2d0
                metrics.d2d_bytes = arena.d2d_bytes - d2d0
            if isinstance(self._ms_spec, float):
                _drop_unswept(plan, tr)
            snapshot, stayed = _assemble(self, known, singles, ms,
                                         boundary_tx, tr)
            n_final = len(snapshot.supports)
            report = RefreshReport(
                generation=snapshot.generation, n_transactions=boundary_tx,
                min_support=ms, frequent=n_final,
                segments_refreshed=pending, dirty_items=len(dirty),
                stayed=stayed, born=n_final - stayed,
                died=len(self._snapshot.supports) - stayed,
                reused=plan.reused,
                swept_delta=plan.swept_delta, swept_full=plan.swept_full,
                rows_touched=metrics.rows_touched,
                bytes_swept=metrics.bytes_swept,
                h2d_bytes=metrics.h2d_bytes, d2d_bytes=metrics.d2d_bytes,
                wall_s=time.perf_counter() - t0, metrics=metrics)
            # the hook observes the world just before the swap and may
            # itself ingest, so it runs OUTSIDE the state lock
            if before_publish is not None:
                before_publish(snapshot)
            t_pub = tr.now() if tr is not None else 0.0
            with self._state:
                # commit point: plain assignments, then the swap
                self._item_support = item_support
                self._known = known
                self._query_known = qk
                self._refreshed_segments = boundary
                self._snapshot = snapshot       # the atomic swap
                self.generation = snapshot.generation
                del self._pending_since[:len(pending)]
                c0 = arena.compaction_bytes
                report.compacted_segments = self._maybe_compact()
                report.compaction_bytes = arena.compaction_bytes - c0
            report.wall_s = time.perf_counter() - t0
            if tr is not None:
                tr.span("publish", t_pub, cat="stream",
                        args={"generation": snapshot.generation})
                tr.span("refresh", t0, cat="stream",
                        args={"generation": snapshot.generation,
                              "segments": len(pending),
                              "frequent": n_final})
                tr.counter("refresh_lag", {"s": self.refresh_lag})
            return report

    # ------------------------------------------------------- multi-host --
    def _refresh_cluster(self, plan: DeltaPlan, item_support, ms: int,
                         singles: Dict[Itemset, int],
                         t0: float) -> MiningMetrics:
        """One refresh generation over the loopback cluster: N driver
        threads, each a :class:`MiningRun` on its host's arena slice and
        persistent cluster runtime, all sharing ONE delta plan (its known
        store is the working copy the caller commits). The cluster
        gauges persist for the miner's life, so the merged metrics report
        THIS refresh's deltas."""
        self._ensure_runtime()
        bus, arenas = self._bus, self._harenas
        g = bus.gauges
        h2d0 = sum(ar.h2d_bytes for ar in arenas)
        d2d0 = sum(ar.d2d_bytes for ar in arenas)
        with g.lock:
            g0 = (g.net_bytes, g.steal_net, g.cross_steals,
                  list(g.eval_s), list(g.eval_bytes))
        n = self._hosts
        mets: List[Optional[MiningMetrics]] = [None] * n
        errs: List[Optional[BaseException]] = [None] * n

        def driver(h: int) -> None:
            try:
                result_h = dict(singles)
                frequent_h = sorted(result_h)
                run = MiningRun(arenas[h], item_counts=item_support,
                                runtime=self._hruntimes[h], **self._run_kw)
                # level-1 frequent is global: bill it once (host 0)
                if h == 0:
                    run.metrics.frequent += len(frequent_h)
                try:
                    mine_more(run, ms, self.max_k, result_h, frequent_h,
                              delta=plan)
                finally:
                    run.close()
                mets[h] = run.finalize(t0)
            except BaseException as e:  # noqa: BLE001 - unblock peers
                errs[h] = e
                bus.abort()

        threads = [threading.Thread(target=driver, args=(h,),
                                    name=f"stream-host-{h}")
                   for h in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if any(e is not None for e in errs):
            bus.barrier.reset()      # un-break it for the next refresh
            # the first host's own error, before the peers' broken barriers
            for e in errs:
                if e is not None and not isinstance(e, RuntimeError):
                    raise e
            raise next(e for e in errs if e is not None)
        m = _cluster.merge_metrics(mets, g, self._run_kw["granularity"])
        m.net_bytes -= g0[0]
        m.steal_net -= g0[1]
        m.cross_steals -= g0[2]
        for row in m.per_host:
            row["eval_s"] -= g0[3][row["host"]]
            row["eval_bytes"] -= g0[4][row["host"]]
        m.h2d_bytes = sum(ar.h2d_bytes for ar in arenas) - h2d0
        m.d2d_bytes = sum(ar.d2d_bytes for ar in arenas) - d2d0
        return m

    @property
    def cluster_gauges(self) -> Optional[Dict[str, int]]:
        """Lifetime interconnect billing (``net_bytes``, ``steal_net``,
        ``cross_steals``, ``reduced_flushes``); None unless
        ``hosts > 1``."""
        if self._hosts < 2:
            return None
        return self._bus.gauges.snapshot()

    # ------------------------------------------------------ observability --
    @property
    def refresh_lag(self) -> float:
        """Seconds the oldest not-yet-published ingest has waited (0.0
        when every ingested segment is in the current generation)."""
        with self._state:
            if not self._pending_since:
                return 0.0
            return time.perf_counter() - self._pending_since[0]

    def metrics_registry(self) -> MetricsRegistry:
        """Pull-based metrics: stream gauges (generation, transaction
        and pending-segment counts, ``refresh_lag_s``), per-kind query
        latency percentiles and, once the runtime exists, its scheduler,
        per-device and arena sources."""
        reg = MetricsRegistry()

        def stream() -> Dict[str, object]:
            with self._state:
                pending = self.arena.n_segments - self._refreshed_segments
                lag = (time.perf_counter() - self._pending_since[0]
                       if self._pending_since else 0.0)
                return {"generation": self.generation,
                        "n_transactions": self.n_transactions,
                        "pending_segments": pending,
                        "refresh_lag_s": lag}

        reg.register("stream", stream)
        reg.register("query_latency", self.latency.percentiles)
        rt = self._runtime
        if rt is not None:
            for name in rt.registry.names():
                reg.register(name, lambda n=name, r=rt:
                             r.registry.snapshot()[n])
        return reg

    # --------------------------------------------------------- compaction --
    def _maybe_compact(self) -> int:
        """Fold the refreshed segments into one when the policy fires
        (caller holds the state lock, no refresh mining in flight).
        In-flight query sweeps hold segment ids compaction renumbers, so
        the gate is drained first — briefly, with queries winning: on
        timeout the fold is skipped and the policy re-fires at the next
        publish. Returns the number of segments removed (always 0 with
        hosts)."""
        r = self._refreshed_segments
        if r < 2 or self._hosts > 1:
            return 0
        lead = self.arena.seg_words(0)
        tail = sum(self.arena.seg_words(g) for g in range(1, r))
        if not (r > self.compact_segments
                or tail <= self.compact_ratio * max(lead, 1)):
            return 0
        if not self._gate.wait_idle(1.0):
            return 0
        return self._compact(r)

    def _compact(self, upto: int) -> int:
        removed = self.arena.compact(upto)
        if removed:
            self._seg_tx[:removed + 1] = [sum(self._seg_tx[:removed + 1])]
            self._refreshed_segments -= removed
        return removed

    def compact_now(self) -> int:
        """Fold every refreshed segment regardless of policy. Returns the
        number of segments removed — 0 if query sweeps stayed in flight
        past the drain timeout, and always 0 with hosts."""
        if self._hosts > 1:
            return 0
        with self._refresh_lock, self._state:
            if not self._gate.wait_idle(5.0):
                return 0
            return self._compact(self._refreshed_segments)

    def __repr__(self) -> str:   # pragma: no cover - debugging aid
        with self._state:
            n_seg = self.arena.n_segments
            pending = n_seg - self._refreshed_segments
            return (f"<StreamingMiner gen={self.generation} "
                    f"tx={self.n_transactions} segments={n_seg} "
                    f"pending={pending} known={len(self._known)}>")


# ---------------------------------------------------------------------------
# multi-tenant serving
# ---------------------------------------------------------------------------

class Tenant:
    """One stream inside a :class:`TenantHub`: the ingest → refresh →
    snapshot/serve lifecycle scoped to the tenant's own tagged segment
    set, sharing the hub's arena and engine runtime with every other
    tenant. Create it with :meth:`TenantHub.tenant`."""

    def __init__(self, hub: "TenantHub", tid, min_support,
                 weight: float = 1.0):
        self.hub = hub
        self.tid = tid
        self.weight = float(weight)
        self.n_items = hub.n_items
        self.max_k = hub.max_k
        self.arena = hub.arena
        self.device = hub.device
        self._ms_spec = min_support
        self.n_transactions = 0
        self.generation = 0
        self._segments: List[int] = []   # refreshed (mined) segments
        self._pending: List[int] = []    # ingested, not yet refreshed
        self._seg_tx: Dict[int, int] = {}
        self._item_support = np.zeros(hub.n_items, np.int64)
        self._known = KnownStore()
        self._query_known: Set[Itemset] = set()
        self._refresh_lock = threading.Lock()
        self._snapshot = PatternSnapshot(0, 0, self._resolve_ms(0), {},
                                         device=self.device)
        self._server: Optional[PatternServer] = None
        # serving plumbing shared hub-wide (one lock, one gate, one
        # dispatcher): queries from every tenant coalesce
        self._state = hub._state
        self._gate = hub._gate
        self._q_rr = hub._q_rr
        # per-tenant meters
        self.sweep_bytes = 0             # mining sweeps (refreshes)
        self.query_sweeps = 0
        self.query_sweep_bytes = 0
        self.last_flush_occupancy = 0.0
        self.latency = LatencyRecorder()
        self._pending_since: List[float] = []

    # shared serving protocol --------------------------------------------
    def _ensure_runtime(self) -> EngineRuntime:
        return self.hub._ensure_runtime()

    def _resolve_ms(self, n_transactions: int) -> int:
        if isinstance(self._ms_spec, float):
            return max(1, int(self._ms_spec * n_transactions))
        return int(self._ms_spec)

    def _query_view(self) -> QueryPlanner:
        return QueryPlanner(self._snapshot, self._known, self._item_support,
                            tuple(self._segments))

    def _commit_answers(self, known_ref, updates) -> None:
        with self._state:
            if self._known is known_ref:
                known_ref.update(updates)
                self._query_known.update(updates)

    def _bill_query(self, n_sweeps: int, nbytes: int) -> None:
        with self._state:
            self.query_sweeps += n_sweeps
            self.query_sweep_bytes += nbytes

    # public surface ------------------------------------------------------
    @property
    def snapshot(self) -> PatternSnapshot:
        return self._snapshot

    @property
    def needs_refresh(self) -> bool:
        with self._state:
            return bool(self._pending)

    @property
    def server(self) -> PatternServer:
        if self._server is None:
            self._server = PatternServer(self)
        return self._server

    def query_supports(self, itemsets: Sequence[Sequence[int]]
                       ) -> List[Tuple[int, bool]]:
        return _serve_queries(self, itemsets)

    def support_many(self, itemsets: Sequence[Sequence[int]]) -> List[int]:
        return [s for s, _ in self.query_supports(itemsets)]

    def ingest(self, batch: Sequence[Sequence[int]]) -> IngestReport:
        """Append a batch as one fresh segment TAGGED with this tenant's
        id: other tenants never sweep it, and arena compaction refuses to
        fold across the tag."""
        return with_gc_spans(self.hub.tracer, self._ingest, batch)

    def _ingest(self, batch: Sequence[Sequence[int]]) -> IngestReport:
        batch = [list(t) for t in batch]
        _check_items(batch, self.n_items)
        t0 = time.perf_counter()
        seg_bm = pack_database(batch, self.n_items)
        with self._state:
            h0 = self.arena.h2d_bytes
            seg = self.arena.add_segment(seg_bm, tenant=self.tid)
            self._pending.append(seg)
            self._pending_since.append(t0)
            self._seg_tx[seg] = len(batch)
            self.n_transactions += len(batch)
            return IngestReport(
                segment=seg, n_transactions=len(batch),
                words=seg_bm.shape[1],
                payload_bytes=self.arena.seg_nbytes(seg),
                h2d_bytes=self.arena.h2d_bytes - h0,
                wall_s=time.perf_counter() - t0)

    def refresh(self, before_publish=None) -> RefreshReport:
        """:meth:`StreamingMiner.refresh` over the tenant's segment set:
        the delta plan's base is the tenant's refreshed and pending
        segments (a non-contiguous subset of the shared arena), and every
        spawned task carries the tenant tag, so the weighted-fair drain
        rule arbitrates between concurrently refreshing tenants."""
        return with_gc_spans(self.hub.tracer, self._refresh, before_publish)

    def _refresh(self, before_publish) -> RefreshReport:
        tr = self.hub.tracer
        with self._refresh_lock:
            t0 = time.perf_counter()
            hub, arena = self.hub, self.arena
            runtime = self._ensure_runtime()
            with self._state:
                pending = tuple(self._pending)
                base_segments = tuple(self._segments) + pending
                boundary_tx = sum(self._seg_tx[g] for g in base_segments)
                known = self._known.copy()
                qk = set(self._query_known)
            t_dirty = tr.now() if tr is not None else 0.0
            deltas = np.zeros(self.n_items, np.int64)
            for g in pending:
                seg = arena.seg_view(g)[:self.n_items]
                deltas += tidlist.popcount32(seg).sum(axis=1)
            dirty = frozenset(int(i) for i in np.nonzero(deltas)[0])
            if tr is not None:
                tr.span("dirty-items", t_dirty, cat=HOST_CAT,
                        args={"segments": len(pending), "dirty": len(dirty)})
            for x in [x for x in qk if x and all(i in dirty for i in x)]:
                known.pop(x, None)
                qk.discard(x)
            item_support = self._item_support + deltas
            ms = self._resolve_ms(boundary_tx)

            def hotness(prefix: Itemset) -> float:
                if len(prefix) == 1:
                    return float(item_support[prefix[0]])
                return float(known.get(prefix, 0))

            plan = DeltaPlan(
                known=known, dirty_items=dirty, segments=pending,
                base_segments=base_segments,
                priority_of=hotness if known else None, tenant=self.tid)
            singles: Dict[Itemset, int] = {
                (i,): int(s) for i, s in enumerate(item_support) if s >= ms}
            result = dict(singles)
            frequent = sorted(result)
            h2d0, d2d0 = arena.h2d_bytes, arena.d2d_bytes
            run = MiningRun(arena, item_counts=item_support,
                            runtime=runtime, **hub._run_kw)
            run.metrics.frequent += len(frequent)
            try:
                mine_more(run, ms, self.max_k, result, frequent, delta=plan)
            finally:
                run.close()
            metrics = run.finalize(t0)
            metrics.h2d_bytes = arena.h2d_bytes - h2d0
            metrics.d2d_bytes = arena.d2d_bytes - d2d0
            if isinstance(self._ms_spec, float):
                _drop_unswept(plan, tr)
            snapshot, stayed = _assemble(self, known, singles, ms,
                                         boundary_tx, tr)
            n_final = len(snapshot.supports)
            report = RefreshReport(
                generation=snapshot.generation, n_transactions=boundary_tx,
                min_support=ms, frequent=n_final,
                segments_refreshed=pending, dirty_items=len(dirty),
                stayed=stayed, born=n_final - stayed,
                died=len(self._snapshot.supports) - stayed,
                reused=plan.reused,
                swept_delta=plan.swept_delta, swept_full=plan.swept_full,
                rows_touched=metrics.rows_touched,
                bytes_swept=metrics.bytes_swept,
                h2d_bytes=metrics.h2d_bytes, d2d_bytes=metrics.d2d_bytes,
                wall_s=time.perf_counter() - t0, metrics=metrics)
            if before_publish is not None:
                before_publish(snapshot)
            with self._state:
                self._item_support = item_support
                self._known = known
                self._query_known = qk
                self._segments = list(base_segments)
                landed = set(pending)
                self._pending = [g for g in self._pending
                                 if g not in landed]
                del self._pending_since[:len(pending)]
                self._snapshot = snapshot
                self.generation = snapshot.generation
                self.sweep_bytes += metrics.bytes_swept
                self.last_flush_occupancy = metrics.batch_occupancy
            report.wall_s = time.perf_counter() - t0
            return report

    @property
    def refresh_lag(self) -> float:
        """Seconds this tenant's oldest unpublished ingest has waited
        (see :attr:`StreamingMiner.refresh_lag`)."""
        with self._state:
            if not self._pending_since:
                return 0.0
            return time.perf_counter() - self._pending_since[0]

    def __repr__(self) -> str:   # pragma: no cover - debugging aid
        with self._state:
            return (f"<Tenant {self.tid!r} gen={self.generation} "
                    f"tx={self.n_transactions} "
                    f"segments={len(self._segments)} "
                    f"pending={len(self._pending)}>")


class TenantHub:
    """Multi-tenant serving: several independent transaction streams
    multiplexed onto ONE :class:`BitmapArena` (on ``device``: None means
    the CUDA card, ``"cpu"`` the kernels' plain versions) and ONE
    persistent :class:`EngineRuntime`.

    Each :class:`Tenant` owns a disjoint set of arena segments (tagged at
    ingest, so compaction never folds across tenants), its own
    min-support spec, known store and published snapshot; refreshes and
    query sweeps from every tenant share the scheduler workers and the
    dispatcher, so their sweeps coalesce into the same launches.
    Fairness: re-mine tasks carry the tenant tag, and the clustered drain
    rule serves the worker-local tenant with the highest ``weight /
    (served + 1)`` deficit first — a heavy tenant gets proportionally
    more engine turns but never starves a light one. Per-tenant meters
    (queries by kind, sweep bytes, flush occupancy, tasks served) surface
    through :meth:`tenant_stats`.

    ``mesh`` shards the hub's arena as ``fpm.mine(mesh=)`` does; every
    tenant's queries then go to the shards' dispatchers in turn.
    ``tracer`` records the shared runtime and every tenant's ingests and
    refreshes, as :class:`StreamingMiner`'s does."""

    def __init__(self, n_items: int, *,
                 device: "torch.device | str | None" = None,
                 policy: str = "clustered", n_workers: int = 4,
                 max_k: int = 6, granularity: str = "bucket",
                 backend: str = "auto", arena: str = "auto",
                 cache_size: int = 32, max_batch: int = MAX_BATCH,
                 flush_us: float = FLUSH_US, mesh=None,
                 representation: str = "auto", tracer=None):
        if n_items < 1:
            raise ValueError(f"n_items must be >= 1, got {n_items}")
        self.device = resolve_device(device)
        self.n_items = n_items
        self.max_k = max_k
        self.tracer = tracer
        self._run_kw = dict(policy=policy, n_workers=n_workers,
                            granularity=granularity, backend=backend,
                            cache_size=cache_size, max_batch=max_batch,
                            flush_us=flush_us,
                            representation=representation)
        # the arena starts with one empty (zero-width) segment; every
        # real segment arrives tagged through Tenant.ingest
        n_shards, devices = _resolve_mesh(mesh)
        self.arena = BitmapArena.from_bitmaps(
            pack_database([], n_items), device=self.device, backing=arena,
            n_shards=n_shards, devices=devices)
        self._state = threading.RLock()
        self._gate = _QueryGate(self._state)
        self._q_rr = itertools.count()
        self._runtime: Optional[EngineRuntime] = None
        self._tenants: Dict[Any, Tenant] = {}

    def _ensure_runtime(self) -> EngineRuntime:
        with self._state:
            if self._runtime is None:
                kw = self._run_kw
                self._runtime = EngineRuntime(
                    self.arena, policy=kw["policy"],
                    n_workers=kw["n_workers"],
                    granularity=kw["granularity"], backend=kw["backend"],
                    max_batch=kw["max_batch"], flush_us=kw["flush_us"],
                    tracer=self.tracer)
                self._push_weights()
            return self._runtime

    def _push_weights(self) -> None:
        # caller holds _state
        runtime = self._runtime
        if runtime is None:
            return      # pushed when the runtime is first built
        policy = runtime.sched.policy
        if isinstance(policy, ClusteredPolicy):
            policy.set_weights(
                {tid: t.weight for tid, t in self._tenants.items()} or None)

    def tenant(self, tid, min_support=None, *,
               weight: float = 1.0) -> Tenant:
        """Register a new tenant stream (``min_support`` required) or
        fetch an existing one by id."""
        with self._state:
            t = self._tenants.get(tid)
            if t is None:
                if min_support is None:
                    raise ValueError("min_support is required when "
                                     "registering a new tenant")
                t = Tenant(self, tid, min_support, weight)
                self._tenants[tid] = t
                self._push_weights()
            return t

    @property
    def tenants(self) -> Tuple[Tenant, ...]:
        with self._state:
            return tuple(self._tenants.values())

    def refresh_all(self) -> Dict[Any, RefreshReport]:
        """Refresh every tenant with pending segments, one after another
        (callers wanting overlap run per-tenant ``refresh`` from their own
        threads; the shared runtime arbitrates)."""
        out = {}
        for t in self.tenants:
            if t.needs_refresh or t.generation == 0:
                out[t.tid] = t.refresh()
        return out

    def tenant_stats(self) -> Dict[Any, Dict[str, Any]]:
        """Per-tenant serving and mining meters: generation, stream size,
        queries served by kind, sweep bytes (mining and query), the last
        refresh's flush occupancy, scheduler tasks served under the
        fairness rule, and the configured weight."""
        with self._state:
            served: Dict[Any, int] = {}
            if self._runtime is not None and isinstance(
                    self._runtime.sched.policy, ClusteredPolicy):
                served = self._runtime.sched.policy.tenant_served()
            out: Dict[Any, Dict[str, Any]] = {}
            for tid, t in self._tenants.items():
                q = (t._server.merged_stats() if t._server is not None
                     else obs_schema.query_stats({}))
                out[tid] = {
                    "generation": t.generation,
                    "transactions": t.n_transactions,
                    "segments": len(t._segments) + len(t._pending),
                    "frequent": len(t._snapshot.supports),
                    "weight": t.weight,
                    "tasks_served": int(served.get(tid, 0)),
                    "sweep_bytes": t.sweep_bytes,
                    "query_sweeps": t.query_sweeps,
                    "query_sweep_bytes": t.query_sweep_bytes,
                    "flush_occupancy": t.last_flush_occupancy,
                    "queries": q,
                }
            return out

    def close(self) -> None:
        """Shut down the shared runtime; snapshots keep serving."""
        with self._state:
            runtime, self._runtime = self._runtime, None
        if runtime is not None:
            runtime.shutdown()

    def __enter__(self) -> "TenantHub":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):   # pragma: no cover - gc-timing dependent
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def __repr__(self) -> str:   # pragma: no cover - debugging aid
        with self._state:
            return (f"<TenantHub items={self.n_items} "
                    f"tenants={len(self._tenants)} "
                    f"segments={self.arena.n_segments}>")
