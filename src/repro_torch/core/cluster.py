"""Multi-host mining: transaction-axis partitioning, two-phase support
counting, cross-host steal-as-migration.

The decomposition is *count distribution* over a partitioned transaction
axis (Yoshizoe et al.; Aouad et al.). Each host owns a contiguous word
range of every TID bitmap — its slice lives in a local
:class:`BitmapArena` on the host's device, whose segment ids stay
globally aligned (streaming ingest appends ZERO-WIDTH segments on
non-owner hosts, which every backend skips) — and runs its own
:class:`TaskScheduler` and :class:`SweepDispatcher`. Support counting is
two-phase: the local backend counts over the owned words, then the
dispatcher's flush hook (``reduce_flush``) evaluates the SAME flush —
shipped as compact *descriptors* (prefix items, extension items, segment
ids; never bitmap payload) — against every peer slice and sums the
partials. One reduction per flush, so the cross-host traffic amortizes
as the kernel launches do. Counts are integer sums of disjoint word
ranges, so results are bit-identical to a single-host ``mine()``.

A peer evaluates a descriptor flush with a backend of the host's kind on
its own slice: each descriptor becomes a tuple-prefix sweep request.
The prefix items are base rows of the slice, so the kernel backend's
``bitmap_join_many`` ANDs the tuple itself and counts the extensions in
one launch per segment, on the slice's device mirror (on a CPU arena,
its plain version); the host backend ANDs and counts the same requests
in numpy.

Task partition rides on :func:`stable_hash`: every driver generates the
full candidate frontier but spawns only the buckets it OWNS
(``stable_hash(prefix) % n_hosts``), then a per-level exchange merges the
counted pairs so every driver thresholds identically.

Two transports implement the same context API:

  ``LoopbackContext``     N logical hosts in one process (driver threads
      and a shared bus). Reduction is a direct peer-slice evaluation;
      the exchange is a barrier and a shared slot. This is the only mode
      with DYNAMIC cross-host steal: an idle host's worker migrates a
      whole bucket from the busiest peer (the victim ships the bucket's
      prefix rows — its owned-word slice — billed to ``steal_net`` and
      ``net_bytes``).
  ``DistributedContext``  real processes over a
      ``torch.distributed.TCPStore`` key-value store. Flushes are
      per-rank and asynchronous (a rank flushes whenever its own workers
      fill a batch), so they cannot be collectives, which every rank must
      enter the same number of times in the same order: descriptor
      flushes are point-to-point eval requests served by one thread per
      peer, level exchanges one blob per rank. Work is statically
      partitioned (no cross-process steal).
"""
from __future__ import annotations

import datetime
import pickle
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import fpm, tidlist
from repro_torch.core.join_backend import (FLUSH_US, MAX_BATCH, SweepRequest,
                                           resolve_backend)
from repro_torch.core.scheduler import stable_hash
from repro_torch.core.tidlist import (BitmapArena, partition_words,
                                      resolve_device)
from repro_torch.obs import schema as obs_schema

Itemset = Tuple[int, ...]


class ClusterGauges:
    """Interconnect billing, shared by every host of one cluster run:
    ``net_bytes`` is everything that crossed (or, loopback, would have
    crossed) the wire — descriptor flushes, count replies, exchange
    blobs and steal migrations; ``steal_net`` is the steal share of it
    (the migrated buckets' prefix-row slices). ``eval_s``/``eval_bytes``
    attribute each peer-slice evaluation to the host that OWNS the
    slice."""

    def __init__(self, n_hosts: int):
        self.lock = threading.Lock()
        self.net_bytes = 0
        self.steal_net = 0
        self.cross_steals = 0
        self.reduced_flushes = 0
        self.eval_s = [0.0] * n_hosts
        self.eval_bytes = [0] * n_hosts

    def snapshot(self) -> Dict[str, int]:
        with self.lock:
            return {"net_bytes": self.net_bytes,
                    "steal_net": self.steal_net,
                    "cross_steals": self.cross_steals,
                    "reduced_flushes": self.reduced_flushes}


def _desc_of(req: SweepRequest, arena: BitmapArena) -> Itemset:
    """The request's portable descriptor: the prefix as base ITEM ids
    (extension handles are always base ids already). Tuple prefixes and
    base-row handles describe themselves; a cached or materialized
    handle means nothing on a peer, so those call sites pass ``desc=``
    — the prefix itemset — explicitly."""
    if req.desc is not None:
        return req.desc
    p = req.prefix_handle
    if isinstance(p, tuple):
        return p
    if p < arena.n_base:
        return (p,)
    raise RuntimeError(
        "cluster sweep of a derived arena handle needs an explicit "
        "desc= (the prefix itemset)")


def _desc_batch(requests: Sequence[SweepRequest], arena: BitmapArena
                ) -> List[Tuple[Itemset, Tuple[int, ...],
                                Optional[Tuple[int, ...]]]]:
    return [(_desc_of(r, arena), r.ext_handles, r.segments)
            for r in requests]


def _desc_nbytes(descs) -> Tuple[int, int]:
    """(request, reply) wire cost of a descriptor flush: 4 B per item /
    segment id out, 8 B per count back."""
    out = sum(len(d) + len(e) + (len(s) if s is not None else 0)
              for d, e, s in descs)
    back = sum(len(e) for _, e, _ in descs)
    return out * 4, back * 8


def _eval_rows_bytes(descs, arena: BitmapArena) -> int:
    """Bytes of ``arena``'s slice a descriptor flush reads in the steady
    state: one prefix row and the extension rows over the swept
    segments' local words."""
    total = 0
    for d, e, s in descs:
        w = (arena.n_words if s is None
             else sum(arena.seg_words(g) for g in s))
        total += (1 + len(e)) * w * 4
    return total


def _desc_requests(descs) -> List[SweepRequest]:
    """A descriptor flush as sweep requests on a peer slice: the prefix
    items are the slice's base rows, one handle or a tuple of them."""
    return [SweepRequest(d if len(d) > 1 else d[0], tuple(e), segments=s)
            for d, e, s in descs]


class _PeerEval:
    """Evaluates descriptor flushes on one host's arena slice with a
    backend of the cluster's kind, as tuple-prefix sweep requests (on
    the kernel backend, through its own staging buffers: one evaluation
    at a time)."""

    def __init__(self, arena: BitmapArena, backend: str):
        self.arena = arena
        self.backend = resolve_backend(backend)
        self._lock = threading.Lock()

    def __call__(self, descs) -> List[np.ndarray]:
        with self._lock:
            return self.backend.sweep_many(self.arena, _desc_requests(descs))


class _LoopbackBus:
    """Shared state of one in-process cluster: the lockstep barrier,
    exchange slots, the host arenas and schedulers, and the migration
    lock that makes cross-host steals atomic against the global
    level-termination check."""

    def __init__(self, n_hosts: int, arenas: List[BitmapArena],
                 backend: str = "auto"):
        self.n = n_hosts
        self.arenas = arenas
        self.backend = backend
        self.gauges = ClusterGauges(n_hosts)
        self.scheds: List[Any] = []
        self.barrier = threading.Barrier(n_hosts)
        self.lock = threading.Lock()
        self.slots: Dict[int, Dict[int, Any]] = {}
        self.rets: Dict[int, Any] = {}
        self.mig_lock = threading.Lock()
        self._level_done = False

    def abort(self) -> None:
        self.barrier.abort()

    def wait(self) -> None:
        try:
            self.barrier.wait()
        except threading.BrokenBarrierError:
            raise RuntimeError(
                "cluster peer host failed (barrier broken)") from None

    def exchange(self, seq: int, host: int, payload,
                 update: Optional[Callable]) -> Any:
        """All-to-all merge at one lockstep point. ``update`` (when
        given) runs ONCE — on host 0, between the barriers — because
        loopback hosts share their delta and known stores; its return
        value is what every host gets back."""
        with self.lock:
            self.slots.setdefault(seq, {})[host] = payload
        self.wait()
        if host == 0:
            with self.lock:
                parts = self.slots.pop(seq)
            merged = [x for h in sorted(parts) for x in parts[h]]
            self.rets[seq] = update(merged) if update else merged
        self.wait()
        ret = self.rets[seq]
        self.wait()                 # all read before host 0 may recycle
        if host == 0:
            with self.lock:
                self.rets.pop(seq, None)
        return ret

    def level_wait(self, host: int) -> None:
        """Global quiescence: a host's own ``wait_all`` is not enough
        once buckets migrate — an idle host's worker may ADOPT work after
        its driver's wait returned. Loop until host 0, holding the
        migration lock (so no donation is mid-flight), sees every
        scheduler idle."""
        scheds = self.scheds
        while True:
            scheds[host].wait_all()
            self.wait()
            if host == 0:
                with self.mig_lock:
                    self._level_done = all(s.idle() for s in scheds)
            self.wait()
            if self._level_done:
                return

    def install_steal(self) -> None:
        """Hook every host's scheduler with the cross-host steal
        protocol: an idle worker (local queues and victims empty) picks
        the busiest PEER host, takes one whole bucket from it and adopts
        it locally. The donated tasks keep their closures — they still
        sweep through the ORIGIN host's dispatcher and arena slice, which
        is the semantics of the victim shipping the bucket's prefix
        bitmap slice; the shipment is billed here (prefix rows × the
        victim's owned words)."""
        bus = self

        def make_steal(thief: int):
            def steal_cb(worker: int) -> int:
                with bus.mig_lock:
                    best, best_q = -1, 0
                    for v, s in enumerate(bus.scheds):
                        if v == thief:
                            continue
                        q = s.queued_approx()
                        if q > best_q:
                            best, best_q = v, q
                    if best < 0:
                        return 0
                    tasks = bus.scheds[best].donate_bucket()
                    if not tasks:
                        return 0
                    rows = sum(len(t.handles) or 1 for t in tasks)
                    moved = rows * bus.arenas[best].n_words * 4
                    with bus.gauges.lock:
                        bus.gauges.cross_steals += 1
                        bus.gauges.steal_net += moved
                        bus.gauges.net_bytes += moved
                    bus.scheds[thief].adopt(tasks, worker=worker)
                    return len(tasks)
            return steal_cb

        def make_work(me: int):
            def work_cb() -> bool:
                return any(not s.idle()
                           for v, s in enumerate(bus.scheds) if v != me)
            return work_cb

        for h, sched in enumerate(self.scheds):
            sched.set_remote_hooks(make_steal(h), make_work(h))


class LoopbackContext:
    """One logical host's view of an in-process cluster: the context API
    the engine consumes (``owns``, ``reduce_flush``, ``exchange``,
    ``level_wait``)."""

    def __init__(self, bus: _LoopbackBus, host_id: int,
                 owner_fn: Optional[Callable[[Itemset], int]] = None):
        self.bus = bus
        self.host_id = host_id
        self.n_hosts = bus.n
        self.arena = bus.arenas[host_id]
        self.gauges = bus.gauges
        self._owner_fn = owner_fn
        # one evaluator per peer slice, private to this origin host
        self._peers = [_PeerEval(a, bus.backend) for a in bus.arenas]
        self._xseq = 0             # lockstep: all hosts count together

    def owns(self, key: Itemset) -> bool:
        if self._owner_fn is not None:
            return self._owner_fn(key) == self.host_id
        return stable_hash(key) % self.n_hosts == self.host_id

    def reduce_flush(self, requests: Sequence[SweepRequest],
                     results: List[np.ndarray]) -> List[np.ndarray]:
        """Phase two of a flush: evaluate the flush's descriptors on
        every peer slice and sum the partial counts. The evaluation runs
        on the calling (origin) thread here, but its time and bytes are
        attributed to the slice-owning host — the capacity a real peer
        would spend."""
        descs = _desc_batch(requests, self.arena)
        out, back = _desc_nbytes(descs)
        totals = [np.asarray(c, np.int64) for c in results]
        for p, peer in enumerate(self._peers):
            if p == self.host_id:
                continue
            t0 = time.perf_counter()
            partial = peer(descs)
            dt = time.perf_counter() - t0
            g = self.gauges
            with g.lock:
                g.net_bytes += out + back
                g.eval_s[p] += dt
                g.eval_bytes[p] += _eval_rows_bytes(descs, peer.arena)
            for i, c in enumerate(partial):
                totals[i] = totals[i] + np.asarray(c, np.int64)
        with self.gauges.lock:
            self.gauges.reduced_flushes += 1
        return totals

    def exchange(self, pairs: Sequence, update: Optional[Callable] = None
                 ) -> Any:
        seq = self._xseq
        self._xseq += 1
        return self.bus.exchange(seq, self.host_id, list(pairs), update)

    def level_wait(self, sched) -> None:
        self.bus.level_wait(self.host_id)


def _parse_address(coordinator: str) -> Tuple[str, int]:
    host, _, port = coordinator.rpartition(":")
    return host, int(port)


class DistributedContext:
    """Real-process transport over a ``torch.distributed.TCPStore`` at
    ``coordinator`` ("host:port"; some process hosts the store).
    Descriptor flushes: the origin writes ``ev/{peer}/{me}/{seq}`` and
    blocks on the reply key ``er/{me}/{peer}/{seq}``; one service thread
    per peer reads its inbox in sequence, evaluates against the local
    slice and writes the counts back. Exchanges: one ``x/{seq}/{rank}``
    blob per rank, the peers' read back. ``update`` runs on EVERY rank
    here — stores are replicated, not shared. Every thread talks to the
    store over its own connection, so a blocked read never holds up
    another thread's write. Work is statically partitioned: no
    cross-process steal."""

    REPLY_TIMEOUT_S = 300.0
    _STOP = b""                 # a service thread's end-of-inbox mark

    def __init__(self, coordinator: str, rank: int, n_procs: int,
                 arena: BitmapArena, backend: str = "auto",
                 owner_fn: Optional[Callable[[Itemset], int]] = None):
        self.address = _parse_address(coordinator)
        self.host_id = rank
        self.n_hosts = n_procs
        self.arena = arena
        self.backend = backend
        self.gauges = ClusterGauges(n_procs)
        self._owner_fn = owner_fn
        self._xseq = 0
        self._send_seq = [0] * n_procs
        self._send_lock = threading.Lock()
        self._local = threading.local()
        # per peer: the inbox sequence number its service thread reads
        # next (advanced before the reply is written, so once every
        # request has been answered it names the key the thread waits on)
        self._svc_seq = [0] * n_procs
        self._threads: List[threading.Thread] = []
        self._svc_error: Optional[BaseException] = None

    def store(self):
        """This thread's own connection to the store."""
        st = getattr(self._local, "store", None)
        if st is None:
            from torch.distributed import TCPStore
            host, port = self.address
            st = self._local.store = TCPStore(
                host, port, is_master=False,
                timeout=datetime.timedelta(seconds=self.REPLY_TIMEOUT_S))
        return st

    def owns(self, key: Itemset) -> bool:
        if self._owner_fn is not None:
            return self._owner_fn(key) == self.host_id
        return stable_hash(key) % self.n_hosts == self.host_id

    # ---------------------------------------------------------- service --
    def start_service(self) -> None:
        for peer in range(self.n_hosts):
            if peer == self.host_id:
                continue
            t = threading.Thread(target=self._serve_peer, args=(peer,),
                                 daemon=True, name=f"cluster-eval-{peer}")
            t.start()
            self._threads.append(t)

    def _serve_peer(self, peer: int) -> None:
        me = self.host_id
        evaluate = _PeerEval(self.arena, self.backend)   # thread-private
        try:
            st = self.store()
            while True:
                seq = self._svc_seq[peer]
                key = f"ev/{me}/{peer}/{seq}"
                blob = st.get(key)
                if blob == self._STOP:
                    return
                descs = pickle.loads(blob)
                t0 = time.perf_counter()
                counts = evaluate(descs)
                dt = time.perf_counter() - t0
                reply = pickle.dumps([np.asarray(c, np.int64)
                                      for c in counts])
                self._svc_seq[peer] = seq + 1
                st.set(f"er/{peer}/{me}/{seq}", reply)
                with self.gauges.lock:
                    self.gauges.eval_s[me] += dt
                    self.gauges.eval_bytes[me] += _eval_rows_bytes(
                        descs, self.arena)
                st.delete_key(key)
        except BaseException as e:  # noqa: BLE001 - surfaced by finish()
            self._svc_error = e

    def _barrier(self, tag: str) -> None:
        st = self.store()
        if st.add(f"{tag}/n", 1) == self.n_hosts:
            st.set(f"{tag}/done", b"1")
        st.wait([f"{tag}/done"])

    def finish(self, tag: str = "fin") -> None:
        """Barrier with every rank, then stop the service threads — no
        rank may tear down its evaluator while a peer still mines. Every
        request to this rank has been answered once the barrier passes,
        so each service thread waits on the next key of its inbox; an
        end mark there stops it."""
        self._barrier(tag)
        st = self.store()
        me = self.host_id
        for peer in range(self.n_hosts):
            if peer != me:
                st.set(f"ev/{me}/{peer}/{self._svc_seq[peer]}", self._STOP)
        for t in self._threads:
            t.join(timeout=self.REPLY_TIMEOUT_S)
            if t.is_alive():
                raise RuntimeError(f"{t.name} did not stop")
        if self._svc_error is not None:
            raise self._svc_error

    def leave(self, tag: str, hosting: bool) -> None:
        """Count this rank out of the store; the rank that hosts the
        store waits until every rank is out before it may close it."""
        st = self.store()
        key = f"{tag}/out"
        st.add(key, 1)
        if hosting:
            deadline = time.monotonic() + self.REPLY_TIMEOUT_S
            while st.add(key, 0) < self.n_hosts:
                if time.monotonic() > deadline:
                    raise RuntimeError("cluster ranks did not leave the "
                                       "store in time")
                time.sleep(0.001)

    # ------------------------------------------------------------ engine --
    def reduce_flush(self, requests: Sequence[SweepRequest],
                     results: List[np.ndarray]) -> List[np.ndarray]:
        descs = _desc_batch(requests, self.arena)
        blob = pickle.dumps(descs)
        me = self.host_id
        sent: List[Tuple[int, int]] = []
        with self._send_lock:
            for peer in range(self.n_hosts):
                if peer == me:
                    continue
                seq = self._send_seq[peer]
                self._send_seq[peer] = seq + 1
                sent.append((peer, seq))
        st = self.store()
        for peer, seq in sent:
            st.set(f"ev/{peer}/{me}/{seq}", blob)
        totals = [np.asarray(c, np.int64) for c in results]
        wire = 0
        for peer, seq in sent:
            key = f"er/{me}/{peer}/{seq}"
            reply = st.get(key)
            wire += len(blob) + len(reply)
            for i, c in enumerate(pickle.loads(reply)):
                totals[i] = totals[i] + np.asarray(c, np.int64)
            st.delete_key(key)
        with self.gauges.lock:
            self.gauges.net_bytes += wire
            self.gauges.reduced_flushes += 1
        return totals

    def exchange(self, pairs: Sequence, update: Optional[Callable] = None
                 ) -> Any:
        seq = self._xseq
        self._xseq += 1
        me = self.host_id
        blob = pickle.dumps(list(pairs))
        st = self.store()
        st.set(f"x/{seq}/{me}", blob)
        parts: Dict[int, list] = {me: list(pairs)}
        wire = 0
        for peer in range(self.n_hosts):
            if peer == me:
                continue
            got = st.get(f"x/{seq}/{peer}")
            wire += len(blob) + len(got)
            parts[peer] = pickle.loads(got)
        with self.gauges.lock:
            self.gauges.net_bytes += wire
        merged = [x for h in sorted(parts) for x in parts[h]]
        return update(merged) if update else merged

    def level_wait(self, sched) -> None:
        sched.wait_all()            # static partition: local quiescence
                                    # suffices; exchanges align ranks

    def allreduce_counts(self, local: np.ndarray) -> np.ndarray:
        """Sum per-item partial counts across ranks (level 1 over the
        partitioned axis), built on :meth:`exchange`."""
        total = np.asarray(local, np.int64).copy()
        merged = self.exchange([np.asarray(local, np.int64)])
        for i, arr in enumerate(merged):
            if i != self.host_id:
                total += arr
        return total


# --------------------------------------------------------------- driving --
def _drive(store: BitmapArena, runtime, min_support: int, max_k: int, *,
           policy: str, n_workers: int, granularity: str,
           cache_size: int, item_counts) -> Tuple[Dict[Itemset, int],
                                                  "fpm.MiningMetrics"]:
    """One host's driver: level 1 from GLOBAL item counts (identical on
    every host), then the shared engines with the cluster context
    threaded through the runtime. Representation is pinned to "bitmap":
    sparse payloads are positional in the LOCAL slice and must not leak
    into cross-host descriptors."""
    t0 = time.perf_counter()   # monotonic: finalize() subtracts from it
    supports = np.asarray(item_counts)
    result: Dict[Itemset, int] = {
        (i,): int(supports[i]) for i in range(store.n_base)
        if supports[i] >= min_support}
    frequent = sorted(result)
    run = fpm.MiningRun(store, policy=policy, n_workers=n_workers,
                        granularity=granularity, cache_size=cache_size,
                        representation="bitmap",
                        item_counts=item_counts, runtime=runtime)
    # the level-1 frequent count is GLOBAL: bill it on host 0 only, so
    # the merged view neither double-counts it (depth-first sums hosts)
    # nor loses it (levelwise takes host 0)
    if runtime.cluster.host_id == 0:
        run.metrics.frequent += len(frequent)
    try:
        fpm.mine_more(run, min_support, max_k, result, frequent)
    finally:
        run.close()
    return result, run.finalize(t0)


_SUM_FIELDS = ("buckets", "cache_hits", "cache_misses",
               "cache_partial_hits", "rows_touched", "bytes_swept",
               "h2d_bytes", "flushes", "d2d_bytes", "migrations",
               "dense_sweeps", "sparse_sweeps",
               "sparse_bytes_swept", "sparse_rows", "densify_ops",
               "densify_bytes", "sparsify_ops", "sparsify_bytes")
_MAX_FIELDS = ("wall_s", "levels", "peak_retained_bitmaps",
               "peak_bytes_retained")


def merge_metrics(per_host: List["fpm.MiningMetrics"],
                  gauges: ClusterGauges, granularity: str
                  ) -> "fpm.MiningMetrics":
    """One cluster-wide metrics view. Per-host gauges SUM; lockstep
    level gauges take host 0 (every levelwise driver counts the global
    frontier) except under depth-first, where each host counts only its
    owned subtrees and the sum is the global figure."""
    m = fpm.MiningMetrics(n_devices=per_host[0].n_devices)
    for f in _SUM_FIELDS:
        setattr(m, f, sum(getattr(h, f) for h in per_host))
    for f in _MAX_FIELDS:
        setattr(m, f, max(getattr(h, f) for h in per_host))
    if granularity == "depth-first":
        m.candidates = sum(h.candidates for h in per_host)
        m.frequent = sum(h.frequent for h in per_host)
    else:
        m.candidates = per_host[0].candidates
        m.frequent = per_host[0].frequent
    m.representation = per_host[0].representation
    # scheduler, per-device and per-host rows all travel the obs schema:
    # counters sum, derived ratios rebuild after the merge
    m.scheduler = obs_schema.scheduler_stats(obs_schema.merge_counters(
        [h.scheduler for h in per_host], obs_schema.SCHEDULER_COUNTERS))
    m.per_device = [
        obs_schema.device_stats({**row, "host": hid})
        for hid, h in enumerate(per_host) for row in h.per_device]
    total_req = sum(int(r["sweep_requests"]) for r in m.per_device)
    m.batch_occupancy = (total_req / m.flushes if m.flushes else 0.0)
    g = gauges.snapshot()
    m.n_hosts = len(per_host)
    m.net_bytes = g["net_bytes"]
    m.steal_net = g["steal_net"]
    m.cross_steals = g["cross_steals"]
    m.per_host = [
        obs_schema.host_stats(
            {"host": hid,
             "bytes_swept": h.bytes_swept,
             "sweep_s": sum(float(r.get("sweep_s", 0.0))
                            for r in h.per_device),
             "eval_s": gauges.eval_s[hid],
             "eval_bytes": gauges.eval_bytes[hid]})
        for hid, h in enumerate(per_host)]
    return m


def host_arenas(bitmaps: np.ndarray, hosts: int, device,
                backing: str = "auto") -> List[BitmapArena]:
    """One arena per host over its word slice of ``bitmaps``."""
    return [BitmapArena.from_bitmaps(np.ascontiguousarray(bitmaps[:, a:b]),
                                     device=device, backing=backing)
            for a, b in partition_words(bitmaps.shape[1], hosts)]


def mine_cluster(bitmaps: np.ndarray, min_support: int, *,
                 hosts: int, device: "torch.device | str | None" = None,
                 policy: str = "clustered", n_workers: int = 8,
                 max_k: int = 8, cache_size: int = 32,
                 granularity: str = "bucket", backend: str = "auto",
                 max_batch: int = MAX_BATCH, flush_us: float = FLUSH_US,
                 item_counts=None,
                 owner_fn: Optional[Callable[[Itemset], int]] = None,
                 tracer=None,
                 ) -> Tuple[Dict[Itemset, int], "fpm.MiningMetrics"]:
    """Loopback-cluster ``mine()``: N logical hosts in one process, each
    with its own word-sliced arena on ``device`` (``None`` = the CUDA
    card), scheduler and dispatcher, reduction by direct peer
    evaluation. Bit-identical to single-host ``mine()``, and the twin of
    the real-process entry point :func:`mine_distributed_process`.

    ``owner_fn`` overrides the ``stable_hash`` bucket→host map (tests use
    it to put every bucket on one host, so cross-host steals MUST fire).
    ``tracer`` (a shared :class:`repro_torch.obs.Tracer`) merges every
    host's lanes into ONE timeline — each host's workers, dispatcher and
    driver record under its own Chrome-trace pid."""
    if hosts < 2:
        raise ValueError(f"mine_cluster needs hosts >= 2, got {hosts}")
    dev = resolve_device(device)
    arenas = host_arenas(bitmaps, hosts, dev)
    if item_counts is None:
        item_counts = tidlist.popcount32(bitmaps).sum(axis=1)
    bus = _LoopbackBus(hosts, arenas, backend)
    ctxs = [LoopbackContext(bus, h, owner_fn) for h in range(hosts)]
    runtimes = [fpm.EngineRuntime(arenas[h], policy=policy,
                                  n_workers=n_workers,
                                  granularity=granularity,
                                  backend=backend, max_batch=max_batch,
                                  flush_us=flush_us, cluster=ctxs[h],
                                  tracer=tracer)
                for h in range(hosts)]
    bus.scheds = [rt.sched for rt in runtimes]
    bus.install_steal()
    results: List[Optional[Dict]] = [None] * hosts
    mets: List[Optional[fpm.MiningMetrics]] = [None] * hosts
    errs: List[Optional[BaseException]] = [None] * hosts

    def driver(h: int) -> None:
        try:
            results[h], mets[h] = _drive(
                arenas[h], runtimes[h], min_support, max_k,
                policy=policy, n_workers=n_workers,
                granularity=granularity, cache_size=cache_size,
                item_counts=item_counts)
        except BaseException as e:  # noqa: BLE001 - peers must unblock
            errs[h] = e
            bus.abort()

    threads = [threading.Thread(target=driver, args=(h,),
                                name=f"cluster-driver-{h}")
               for h in range(hosts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        # the first host's own error, before the peers' broken barriers
        for e in errs:
            if e is not None and not isinstance(e, RuntimeError):
                raise e
        for e in errs:
            if e is not None:
                raise e
    finally:
        for rt in runtimes:
            rt.shutdown()
    merged = merge_metrics(mets, bus.gauges, granularity)
    return results[0], merged


def mine_distributed_process(bitmaps: np.ndarray, min_support: int, *,
                             rank: int, n_procs: int, coordinator: str,
                             device: "torch.device | str | None" = None,
                             serve_store: Optional[bool] = None,
                             policy: str = "clustered",
                             n_workers: int = 4, max_k: int = 6,
                             cache_size: int = 32,
                             granularity: str = "bucket",
                             backend: str = "auto",
                             max_batch: int = MAX_BATCH,
                             flush_us: float = FLUSH_US,
                             ) -> Tuple[Dict[Itemset, int],
                                        "fpm.MiningMetrics"]:
    """One rank of a real multi-process mine over a TCPStore at
    ``coordinator`` ("host:port"). Every process passes the same packed
    database, keeps only its word slice (on ``device``; ``None`` = the
    CUDA card, which every rank of one machine shares) and drives the
    shared engines with the store transport. ``serve_store`` makes this
    process host the store (default: rank 0); pass ``False`` everywhere
    when another process, such as a launcher, hosts it. Returns this
    rank's (full, exchanged) result and metrics — every rank holds the
    identical result dict at the end."""
    from torch.distributed import TCPStore
    dev = resolve_device(device)
    if serve_store is None:
        serve_store = rank == 0
    host, port = _parse_address(coordinator)
    server = (TCPStore(host, port, is_master=True, wait_for_workers=False)
              if serve_store else None)
    a, b = partition_words(bitmaps.shape[1], n_procs)[rank]
    arena = BitmapArena.from_bitmaps(np.ascontiguousarray(bitmaps[:, a:b]),
                                     device=dev)
    ctx = DistributedContext(coordinator, rank, n_procs, arena,
                             backend=backend)
    ctx.start_service()
    tag = f"fin-{granularity}-{min_support}"
    # level 1 two-phase, like every later level: local partial popcount
    # over owned words, summed through the transport
    local = tidlist.popcount32(arena.seg_view(0)).sum(axis=1)
    item_counts = ctx.allreduce_counts(local)
    runtime = fpm.EngineRuntime(arena, policy=policy, n_workers=n_workers,
                                granularity=granularity, backend=backend,
                                max_batch=max_batch, flush_us=flush_us,
                                cluster=ctx)
    try:
        result, met = _drive(arena, runtime, min_support, max_k,
                             policy=policy, n_workers=n_workers,
                             granularity=granularity,
                             cache_size=cache_size,
                             item_counts=item_counts)
        ctx.finish(tag)
    finally:
        runtime.shutdown()
    ctx.leave(tag, hosting=serve_store)
    del server
    g = ctx.gauges.snapshot()
    met.n_hosts = n_procs
    met.net_bytes = g["net_bytes"]
    met.steal_net = g["steal_net"]
    met.cross_steals = g["cross_steals"]
    return result, met
