"""PFunc analogue: a task-parallel runtime with *pluggable scheduling
policies* and *task attributes* (Sections 3-4 of the paper).

- ``Task`` carries an attribute (``attr``) — the paper's "task priority",
  which for FPM is a reference to the k-itemset being mined.
- A *policy* owns the per-worker queue structure and steal semantics:
    CilkPolicy      — per-worker LIFO deque, steal ONE task from the
                      opposite end of a random victim (Cilk-style work
                      stealing [Blumofe & Leiserson]).
    FifoPolicy      — per-worker FIFO deque, steal one.
    ClusteredPolicy — per-worker *hash table of buckets* keyed by the
                      task attribute's cluster hash; workers drain one
                      bucket at a time; steals take an ENTIRE bucket
                      (the paper's contribution).
- Worker threads release the GIL inside task bodies (numpy compute), and
  the sweep dispatcher releases it inside its kernel launches, so
  wall-clock speedups are real.

Hardware counters (PAPI in the paper) are replaced by scheduler-level
locality metrics: per-worker steal counts, tasks-per-steal, and bucket
switches; the FPM driver adds a prefix-intersection cache whose hit rate
is the direct analogue of the paper's dTLB locality (DESIGN.md §7).
"""
from __future__ import annotations

import collections
import random
import threading
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import schema as obs_schema


def stable_hash(key: Any) -> int:
    """Process-stable hash for worker placement: CRC32 of a canonical
    repr. Python's built-in ``hash`` is salted per process for str (and
    anything containing one), so ``hash(cluster_key) % n_workers``
    placed externally-spawned tasks on DIFFERENT workers from one run
    to the next — placement (and therefore device affinity, steal
    traffic, and locality metrics) was irreproducible across
    processes. ``repr`` of the int/tuple/str cluster keys used here is
    canonical, so this hash is not."""
    return zlib.crc32(repr(key).encode("utf-8"))


@dataclass
class Task:
    fn: Callable[..., Any]
    args: Tuple
    attr: Any = None          # task attribute (paper: the itemset ref)
    depth: int = 0            # prefix depth: deeper tasks drain first
    priority: float = 0.0     # staleness priority: stale-hot buckets
                              # drain first (streaming re-mine)
    tenant: Any = None        # owning tenant (multi-tenant serving):
                              # the weighted-fair drain's accounting key
    handles: Tuple[int, ...] = ()   # arena handles the task retains —
                                    # a cross-device steal migrates them
    result: Any = None
    error: Optional[BaseException] = None   # set if the body raised


@dataclass
class WorkerStats:
    tasks_run: int = 0
    steals: int = 0           # successful steal operations
    tasks_stolen: int = 0     # tasks acquired via steals
    steal_attempts: int = 0   # victim probes (incl. empty)
    steal_migrations: int = 0  # cross-device bucket-steal EVENTS this
                               # worker won (the arena's `migrations`
                               # gauge counts ROWS re-owned instead).
                               # Drain-bucket switches live on the
                               # clustered policies (`.switches`, per
                               # worker), not here.
    # locality traffic counters, shared with the distributed engine's
    # plan accounting (repro_torch.core.buckets): task bodies add the bitmap
    # rows/bytes they swept via TaskScheduler.worker_stats()
    rows_touched: int = 0
    bytes_swept: int = 0
    # handle-based sweep requests this worker enqueued on the sweep
    # dispatcher (repro_torch.core.join_backend); together with the
    # dispatcher's flush count this yields batch_occupancy
    sweeps_submitted: int = 0
    # hybrid-representation split: how many of this worker's sweeps ran
    # against a dense word-column prefix vs a tid-list/diffset one, and
    # the byte share of bytes_swept that went through the sparse
    # (gather-intersect) path
    dense_sweeps: int = 0
    sparse_sweeps: int = 0
    sparse_bytes_swept: int = 0


class SchedulingPolicy:
    """The scheduler 'concept' (paper §3): queue structure + steal rule."""

    def __init__(self, n_workers: int):
        self.n_workers = n_workers
        self.locks = [threading.Lock() for _ in range(n_workers)]

    def put(self, worker: int, task: Task) -> None:
        raise NotImplementedError

    def get(self, worker: int) -> Optional[Task]:
        raise NotImplementedError

    def steal(self, thief: int, victim: int) -> List[Task]:
        raise NotImplementedError

    def approx_len(self, worker: int) -> int:
        raise NotImplementedError


class CilkPolicy(SchedulingPolicy):
    """LIFO deque per worker; steal one task from the other end."""

    def __init__(self, n_workers: int):
        super().__init__(n_workers)
        self.queues: List[collections.deque] = [collections.deque()
                                                for _ in range(n_workers)]

    def put(self, worker, task):
        with self.locks[worker]:
            self.queues[worker].append(task)

    def get(self, worker):
        with self.locks[worker]:
            q = self.queues[worker]
            return q.pop() if q else None       # LIFO (depth-first)

    def steal(self, thief, victim):
        with self.locks[victim]:
            q = self.queues[victim]
            return [q.popleft()] if q else []   # breadth end, one task

    def approx_len(self, worker):
        return len(self.queues[worker])


class FifoPolicy(CilkPolicy):
    def get(self, worker):
        with self.locks[worker]:
            q = self.queues[worker]
            return q.popleft() if q else None


class ClusteredPolicy(SchedulingPolicy):
    """Paper §4: hash-table-of-buckets queues; bucket-granularity steals.

    ``cluster_of(attr)`` maps a task attribute to its bucket key (for FPM:
    XOR of item hashes over the (k-1)-prefix).

    Drain-bucket selection is *priority-then-depth-first*: when the
    current drain bucket empties, the bucket whose head task has the
    highest ``Task.priority`` (staleness-hotness, set by the streaming
    re-mine so popular stale prefixes converge first), tie-broken by
    the deepest ``Task.depth``, is picked next, scanning at most
    ``DRAIN_SCAN_CAP`` buckets. For the level-synchronous batch engine
    every task has priority 0 and depth 0 and this degenerates to the
    paper's first-non-empty rule; for the barrier-free engine the depth
    tiebreak drains each subtree before starting the next, bounding the
    number of retained parent-handed bitmaps.

    Multi-tenant fairness (:meth:`set_weights`): when tenant weights
    are configured, drain selection ranks buckets by *weighted
    deficit* first — ``weight(tenant) / (tasks served for tenant +
    1)``, per worker — so a heavy tenant's refresh cannot starve a
    light tenant's tasks out of the drain order; priority and depth
    break ties WITHIN the deficit rank, preserving the staleness /
    subtree semantics inside each tenant's share. With no weights set
    (every single-tenant run) the rank and the O(1) fast path are
    byte-for-byte the old behaviour.
    """

    DRAIN_SCAN_CAP = 64   # bound the deepest-bucket scan per switch

    def __init__(self, n_workers: int,
                 cluster_of: Callable[[Any], int] = hash):
        super().__init__(n_workers)
        self.cluster_of = cluster_of
        self.tables: List[Dict[int, collections.deque]] = [
            dict() for _ in range(n_workers)]
        self._drain: List[Optional[int]] = [None] * n_workers
        self.sizes = [0] * n_workers
        self._deep = [0] * n_workers   # queued tasks with depth > 0
        self._hot = [0] * n_workers    # queued tasks with priority > 0
        self.switches = [0] * n_workers  # drain-bucket selections (the
                                         # paper's bucket-switch count)
        self.weights: Optional[Dict[Any, float]] = None
        # per-worker tasks-served tally per tenant (the deficit
        # denominator); merged across workers by tenant_served()
        self._served: List[Dict[Any, int]] = [
            dict() for _ in range(n_workers)]

    def set_weights(self, weights: Optional[Dict[Any, float]]) -> None:
        """Configure tenant fairness weights (None/{} disables and
        restores the single-tenant fast path). Unlisted tenants —
        including ``tenant=None`` tasks — weigh 1.0."""
        self.weights = dict(weights) if weights else None

    def tenant_served(self) -> Dict[Any, int]:
        """Tasks drained per tenant, merged across workers."""
        out: Dict[Any, int] = {}
        for served in self._served:
            for t, n in served.items():
                out[t] = out.get(t, 0) + n
        return out

    def _deficit(self, worker: int, tenant: Any) -> float:
        w = self.weights.get(tenant, 1.0)
        return w / (self._served[worker].get(tenant, 0) + 1)

    def put(self, worker, task):
        key = self.cluster_of(task.attr)
        with self.locks[worker]:
            self.tables[worker].setdefault(key, collections.deque()
                                           ).append(task)
            self.sizes[worker] += 1
            if task.depth > 0:
                self._deep[worker] += 1
            if task.priority > 0:
                self._hot[worker] += 1

    def _pick_drain(self, worker: int,
                    tab: Dict[Any, collections.deque]) -> Any:
        """Highest-(priority, depth) head bucket among the NEWEST
        DRAIN_SCAN_CAP (dict order is insertion order, so the
        just-spawned deep children sit at the tail — scanning
        oldest-first would leave them beyond the cap whenever >CAP
        classes queue up, inverting the drain order and unbounding the
        retained-bitmap peak). With no deep or hot task queued (the
        level-synchronous batch engines: every depth and priority is 0)
        this is the paper's O(1) first-non-empty rule. Tenant weights
        prepend the weighted-deficit rank (see class docstring)."""
        weights = self.weights
        if (weights is None and not self._deep[worker]
                and not self._hot[worker]):
            return next(iter(tab))
        best, best_rank = None, None
        for i, key in enumerate(reversed(tab)):
            if i >= self.DRAIN_SCAN_CAP:
                break
            head = tab[key][0]
            rank = (head.priority, head.depth)
            if weights is not None:
                rank = (self._deficit(worker, head.tenant),) + rank
            if best_rank is None or rank > best_rank:
                best, best_rank = key, rank
        return best

    def get(self, worker):
        with self.locks[worker]:
            tab = self.tables[worker]
            if not tab:
                return None
            key = self._drain[worker]
            if key is None or key not in tab:
                key = self._pick_drain(worker, tab)
                self._drain[worker] = key
                self.switches[worker] += 1
            q = tab[key]
            task = q.popleft()
            if not q:
                del tab[key]
                self._drain[worker] = None
            self.sizes[worker] -= 1
            if task.depth > 0:
                self._deep[worker] -= 1
            if task.priority > 0:
                self._hot[worker] -= 1
            if self.weights is not None:
                served = self._served[worker]
                served[task.tenant] = served.get(task.tenant, 0) + 1
            return task

    def steal(self, thief, victim):
        with self.locks[victim]:
            tab = self.tables[victim]
            for key in list(tab):
                if key == self._drain[victim]:
                    continue                    # don't yank the hot bucket
                q = tab.pop(key)
                self._unaccount(victim, q)
                return list(q)                  # the WHOLE bucket
            # only the drain bucket remains: take it anyway
            for key in list(tab):
                q = tab.pop(key)
                self._unaccount(victim, q)
                self._drain[victim] = None
                return list(q)
            return []

    def _unaccount(self, victim: int, q: collections.deque) -> None:
        self.sizes[victim] -= len(q)
        self._deep[victim] -= sum(1 for t in q if t.depth > 0)
        self._hot[victim] -= sum(1 for t in q if t.priority > 0)

    def approx_len(self, worker):
        return self.sizes[worker]


class NearestNeighborPolicy(ClusteredPolicy):
    """The paper's FUTURE-WORK proposal (§6), implemented: a dynamic
    policy where a thread picks the bucket *nearest* to the task it just
    executed (here: largest item overlap between bucket keys, which are
    the prefix tuples themselves). Pairs with the hierarchical prefix
    cache in repro_torch.core.fpm — neighbouring buckets share sub-prefixes, so
    partial intersections get reused across buckets, not only within one.
    """

    SCAN_CAP = 64   # bound the nearest-neighbour scan per switch

    def __init__(self, n_workers: int,
                 cluster_of: Callable[[Any], Any] = lambda a: a):
        super().__init__(n_workers, cluster_of)
        self._last: List[Optional[tuple]] = [None] * n_workers

    def get(self, worker):
        with self.locks[worker]:
            tab = self.tables[worker]
            if not tab:
                return None
            key = self._drain[worker]
            if key is None or key not in tab:
                last = self._last[worker]
                if last is None:
                    key = self._pick_drain(worker, tab)
                else:
                    # newest-first, like _pick_drain: fresh deep
                    # children live at the dict tail. Staleness
                    # priority dominates the nearest-neighbour rule —
                    # a stale-hot bucket is served before a merely
                    # nearby one, so the serving layer converges on
                    # popular prefixes first — then item overlap, then
                    # the depth-first tiebreak. Tenant weights prepend
                    # the weighted-deficit rank, like _pick_drain.
                    weights = self.weights
                    best, best_rank = None, None
                    for i, cand in enumerate(reversed(tab)):
                        if i >= self.SCAN_CAP:
                            break
                        ov = len(set(cand) & set(last)) \
                            if isinstance(cand, tuple) else 0
                        head = tab[cand][0]
                        rank = (head.priority, ov, head.depth)
                        if weights is not None:
                            rank = (self._deficit(worker, head.tenant),
                                    ) + rank
                        if best_rank is None or rank > best_rank:
                            best, best_rank = cand, rank
                    key = best
                self._drain[worker] = key
                self.switches[worker] += 1
            q = tab[key]
            task = q.popleft()
            if not q:
                del tab[key]
                self._drain[worker] = None
            if isinstance(key, tuple):
                self._last[worker] = key
            self.sizes[worker] -= 1
            if task.depth > 0:
                self._deep[worker] -= 1
            if task.priority > 0:
                self._hot[worker] -= 1
            if self.weights is not None:
                served = self._served[worker]
                served[task.tenant] = served.get(task.tenant, 0) + 1
            return task


class TaskScheduler:
    """Spawn tasks, run them on N worker threads under a policy, wait.

    ``device_of`` pins each worker to a device shard (the mesh-aware
    engine's affinity map; defaults to one shared shard). Because the
    clustered policy places tasks on workers by bucket hash, bucket
    placement *is* device placement. ``migrate_cb(handles, src, dst)``
    fires when a steal crosses device shards — the thief's explicit
    migration of the stolen bucket's retained arena bitmaps."""

    def __init__(self, n_workers: int, policy: SchedulingPolicy,
                 seed: int = 0,
                 device_of: Optional[Sequence[int]] = None,
                 migrate_cb: Optional[
                     Callable[[List[int], int, int], Any]] = None,
                 tracer=None, trace_pid: int = 0):
        self.n = n_workers
        # observability: None = tracing off (workers pay one `is not
        # None` test per event site); trace_pid is the host rank lane
        # group in cluster mode
        self.tracer = tracer
        self.trace_pid = trace_pid
        self.device_of = (list(device_of) if device_of is not None
                          else [0] * n_workers)
        if len(self.device_of) != n_workers:
            raise ValueError("device_of must have one entry per worker")
        self._migrate_cb = migrate_cb
        self.policy = policy
        self.stats = [WorkerStats() for _ in range(n_workers)]
        self._tls = threading.local()
        self._external_stats = WorkerStats()   # non-worker threads
        self._spawned = 0
        self._outstanding = 0
        self._work_seq = 0        # bumped on every put; parked workers
                                  # wait for it to move (wake-on-put)
        self._parked = 0          # workers currently parked on _cv
        self._cv = threading.Condition()
        self._stop = False
        self._rngs = [random.Random(seed + i) for i in range(n_workers)]
        self._spawn_rr = 0
        # cross-host steal hooks (cluster mode): _remote_steal_cb(i)
        # tries to migrate a bucket from a peer host's scheduler and
        # returns the number of tasks adopted; _remote_work_cb() says
        # whether any peer still has work, so idle workers keep a
        # timed park instead of sleeping through a steal opportunity.
        self._remote_steal_cb: Optional[Callable[[int], int]] = None
        self._remote_work_cb: Optional[Callable[[], bool]] = None
        self._threads = [
            threading.Thread(target=self._worker, args=(i,), daemon=True)
            for i in range(n_workers)]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------ spawn --
    def spawn(self, fn, *args, attr=None, depth: int = 0,
              priority: float = 0.0, tenant: Any = None,
              handles: Tuple[int, ...] = (),
              worker: Optional[int] = None):
        """Enqueue a task. When called from inside a task body, the child
        defaults onto the *spawning worker's* queue — the paper's runtime
        semantics: locality by construction, and a stolen bucket carries
        its whole subtree because descendants spawn on the thief. From
        the driver thread, placement is the bucket hash (ClusteredPolicy,
        via :func:`stable_hash` so placement reproduces across
        processes) or round-robin (approximates even initial placement).
        ``priority`` is the staleness-hotness the clustered policies'
        drain selection prefers; ``tenant`` tags the task for the
        weighted-fair drain (multi-tenant serving); ``handles`` names
        arena rows the task retains (the depth-first handoff bitmaps);
        a cross-device steal migrates them."""
        task = Task(fn, args, attr, depth, priority, tenant, handles)
        if worker is None:
            worker = getattr(self._tls, "worker_id", None)
        if worker is None:
            if isinstance(self.policy, ClusteredPolicy):
                worker = stable_hash(self.policy.cluster_of(attr)) % self.n
            else:
                worker = self._spawn_rr = (self._spawn_rr + 1) % self.n
        with self._cv:
            # one critical section: the outstanding bump must precede
            # the put (a fast child finishing before the bump could let
            # a blocked wait_all miss its wake), and the put must
            # precede the wake so a woken worker finds the task.
            # policy.put only takes per-worker policy locks, never _cv,
            # so the nesting cannot invert.
            self._spawned += 1
            self._outstanding += 1
            self.policy.put(worker, task)
            self._work_seq += 1
            if self._parked:
                self._cv.notify_all()
        return task

    def _signal_work(self):
        """Wake parked workers after new tasks became runnable. The
        notify is skipped when nobody is parked — the common case on a
        busy scheduler, where tasks spawn thousands of children."""
        with self._cv:
            self._work_seq += 1
            if self._parked:
                self._cv.notify_all()

    def wait_all(self):
        """Block until no task is outstanding. Dynamic: a task that
        spawns children mid-body keeps the count above zero (the child
        increments before the parent's own decrement), so one terminal
        wait covers a task graph that grows from inside tasks — no
        inter-level barriers needed."""
        with self._cv:
            self._cv.wait_for(lambda: self._outstanding == 0)

    def worker_stats(self) -> WorkerStats:
        """The calling thread's WorkerStats. Task bodies use this to
        account locality traffic (rows_touched / bytes_swept); calls
        from non-worker threads land in a shared fallback bucket that
        merged_stats() still includes."""
        return getattr(self._tls, "stats", self._external_stats)

    def worker_device(self) -> int:
        """The calling worker's device shard (0 for non-worker
        threads, e.g. the driver spawning root tasks)."""
        wid = getattr(self._tls, "worker_id", None)
        return 0 if wid is None else self.device_of[wid]

    def shutdown(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)

    # ---------------------------------------------------- cross-host steal --
    def set_remote_hooks(self, steal_cb: Callable[[int], int],
                         work_cb: Callable[[], bool]) -> None:
        """Install the cluster's cross-host steal protocol. ``steal_cb``
        runs on an idle worker AFTER its local probes all failed — the
        last-resort escalation that keeps the locality preference (own
        queue, then local victims, then a peer host)."""
        self._remote_steal_cb = steal_cb
        self._remote_work_cb = work_cb
        with self._cv:
            # force every already-parked worker through a fresh probe:
            # a worker that parked UNTIMED before the hooks existed
            # would otherwise sleep through every steal opportunity
            # (no local put will ever wake a host that owns no work)
            self._work_seq += 1
            if self._parked:
                self._cv.notify_all()

    def idle(self) -> bool:
        """True when nothing is outstanding here — spawned work that
        was DONATED to a peer counts against the adopter, so a cluster
        level is quiescent iff every host's scheduler is idle."""
        return self._outstanding == 0

    def queued_approx(self) -> int:
        """Racy total of queued (not yet running) tasks — the steal
        victim-selection signal, same contract as ``approx_len``."""
        return sum(self.policy.approx_len(i) for i in range(self.n))

    def donate_bucket(self) -> List[Task]:
        """Victim side of a cross-host steal: remove one bucket's tasks
        from this scheduler entirely — they stop counting against OUR
        outstanding total the moment they leave, and the adopter books
        them before any runs, so the window where neither host counts
        them is covered by the caller's migration lock (the global
        termination check takes the same lock)."""
        got: List[Task] = []
        for v in range(self.n):
            if self.policy.approx_len(v) == 0:
                continue
            got = list(self.policy.steal(0, v) or [])
            if got:
                break
        if got:
            with self._cv:
                self._outstanding -= len(got)
                if self._outstanding == 0:
                    self._cv.notify_all()
        return got

    def adopt(self, tasks: List[Task], worker: int = 0) -> None:
        """Thief side: book and enqueue migrated tasks on ``worker``'s
        queue. The tasks keep their closures — they still sweep through
        the ORIGIN host's dispatcher/arena (that is the migration's
        "shipped prefix slice"), and children they spawn route back to
        the origin scheduler too, keeping every arena handle on the
        host that owns it."""
        if not tasks:
            return
        with self._cv:
            for t in tasks:
                self._spawned += 1
                self._outstanding += 1
                self.policy.put(worker, t)
            self._work_seq += 1
            if self._parked:
                self._cv.notify_all()

    # ----------------------------------------------------------- worker --
    def _acquire(self, i: int) -> Optional[Task]:
        task = self.policy.get(i)
        if task is not None:
            return task
        st = self.stats[i]
        rng = self._rngs[i]
        tr = self.tracer
        t_steal = tr.now() if tr is not None else 0.0
        for _ in range(4 * self.n):
            victim = rng.randrange(self.n)
            if victim == i:
                continue
            st.steal_attempts += 1
            got = self.policy.steal(i, victim)
            if got:
                st.steals += 1
                st.tasks_stolen += len(got)
                src, dst = self.device_of[victim], self.device_of[i]
                if src != dst:
                    # cross-device steal = explicit migration: the
                    # stolen bucket's retained handoff bitmaps move
                    # (and are accounted) before any task runs here
                    st.steal_migrations += 1
                    if self._migrate_cb is not None:
                        moved = [h for t in got for h in t.handles]
                        if moved:
                            self._migrate_cb(moved, src, dst)
                if len(got) > 1:
                    for t in got[1:]:
                        self.policy.put(i, t)
                    self._signal_work()
                if tr is not None:
                    tr.span("steal", t_steal, cat="steal",
                            args={"victim": victim, "tasks": len(got),
                                  "migrated": src != dst, "hit": True})
                return got[0]
        # local queues and victims are all dry: escalate to a
        # cross-host steal if a cluster installed one. The callback
        # adopts a peer bucket onto THIS worker's queue, so a plain
        # re-probe picks it up.
        cb = self._remote_steal_cb
        if cb is not None and (self._remote_work_cb is None
                               or self._remote_work_cb()):
            st.steal_attempts += 1
            n = cb(i)
            if n > 0:
                st.steals += 1
                st.tasks_stolen += n
                if tr is not None:
                    tr.span("steal", t_steal, cat="steal",
                            args={"remote": True, "tasks": n,
                                  "hit": True})
                return self.policy.get(i)
        if tr is not None:
            tr.span("steal", t_steal, cat="steal", args={"hit": False})
        return None

    def _worker(self, i: int):
        st = self.stats[i]
        self._tls.stats = st
        self._tls.worker_id = i
        tr = self.tracer
        if tr is not None:
            tr.set_lane(f"worker-{i}", sort_index=10 + i,
                        pid=self.trace_pid)
        while True:
            # Snapshot the put sequence BEFORE probing the queues: a
            # spawn that lands between a failed probe and the park bumps
            # _work_seq past the snapshot, so the park predicate is
            # already true and the worker does not sleep on a runnable
            # task. (Put and bump share spawn's critical section, so a
            # snapshot that saw the bump also guarantees _acquire can
            # see the task.)
            with self._cv:
                if self._stop:
                    return
                seen = self._work_seq
            task = self._acquire(i)
            if task is None:
                # Park on the condition variable until a put bumps
                # _work_seq past the snapshot (or shutdown). No
                # busy-spin: an idle worker burns no CPU while one deep
                # branch stays live. The timeout is a residual safety
                # net (e.g. a steal victim's queue refilling between
                # our probe and the park without a new put) — but with
                # NOTHING outstanding there is no queue to refill and
                # no running task to spawn, so a fully idle scheduler
                # parks untimed: a persistent serving runtime costs
                # zero wakeups between refreshes.
                t_park = tr.now() if tr is not None else 0.0
                with self._cv:
                    if self._stop:
                        return
                    self._parked += 1
                    try:
                        # with cluster hooks installed, "nothing
                        # outstanding HERE" is not "nothing to do": a
                        # peer host may have (or later GET) stealable
                        # work, and no local put will ever wake us for
                        # it — so cluster mode always keeps the timed
                        # park. ~20 cheap probes/s per idle worker,
                        # only while a cluster is attached.
                        untimed = (self._outstanding == 0
                                   and self._remote_work_cb is None)
                        self._cv.wait_for(
                            lambda: (self._stop
                                     or self._work_seq != seen),
                            timeout=(None if untimed else 0.05))
                    finally:
                        self._parked -= 1
                if tr is not None:
                    tr.span("park", t_park, cat="idle")
                continue
            t_task = tr.now() if tr is not None else 0.0
            try:
                task.result = task.fn(*task.args)
            except BaseException as e:  # noqa: BLE001 - must not leak:
                task.error = e          # a dead worker would deadlock
                                        # wait_all (outstanding never 0)
            finally:
                task.args = ()      # drop arg refs even on error:
                                    # parent-handed bitmaps must free
                                    # once consumed
            if tr is not None:
                attr = task.attr
                args = {"depth": task.depth}
                if isinstance(attr, tuple) and len(attr) == 2:
                    args["bucket"] = attr[0]
                    args["prefix"] = repr(attr[1])
                elif attr is not None:
                    args["prefix"] = repr(attr)
                tr.span("task", t_task, cat="task", args=args)
            st.tasks_run += 1
            with self._cv:
                self._outstanding -= 1
                if self._outstanding == 0:
                    self._cv.notify_all()

    # ------------------------------------------------------------ stats --
    def merged_stats(self) -> Dict[str, float]:
        """Scheduler-wide counters on the ``repro_torch.obs.schema``
        scheduler schema (counters int, ``tasks_per_steal`` the only
        derived float — recomputed, never summed)."""
        s = list(self.stats) + [self._external_stats]
        return obs_schema.scheduler_stats({
            "tasks_run": sum(w.tasks_run for w in s),
            "spawned": self._spawned,
            "steals": sum(w.steals for w in s),
            "tasks_stolen": sum(w.tasks_stolen for w in s),
            "steal_attempts": sum(w.steal_attempts for w in s),
            # drain-bucket switches are counted at the queue by the
            # clustered policies; non-bucket policies report 0
            "bucket_switches": sum(getattr(self.policy, "switches",
                                           ())),
            "steal_migrations": sum(w.steal_migrations for w in s),
            "rows_touched": sum(w.rows_touched for w in s),
            "bytes_swept": sum(w.bytes_swept for w in s),
            "sweeps_submitted": sum(w.sweeps_submitted for w in s),
            "dense_sweeps": sum(w.dense_sweeps for w in s),
            "sparse_sweeps": sum(w.sparse_sweeps for w in s),
            "sparse_bytes_swept": sum(w.sparse_bytes_swept for w in s),
        })


def make_policy(name: str, n_workers: int,
                cluster_of: Callable[[Any], Any] = hash
                ) -> SchedulingPolicy:
    if name == "cilk":
        return CilkPolicy(n_workers)
    if name == "fifo":
        return FifoPolicy(n_workers)
    if name == "clustered":
        return ClusteredPolicy(n_workers, cluster_of)
    if name == "nn":
        return NearestNeighborPolicy(n_workers, cluster_of)
    raise ValueError(name)
