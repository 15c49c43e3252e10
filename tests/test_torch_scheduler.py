"""The port's scheduler passes the reference's deterministic scheduler
cases, and places and drains tasks exactly as the reference does."""
import threading

import numpy as np
import pytest

from repro.core import scheduler as rs
from repro_torch.core import scheduler as ts
from repro_torch.core.scheduler import (CilkPolicy, ClusteredPolicy,
                                        FifoPolicy, NearestNeighborPolicy,
                                        Task, TaskScheduler, make_policy)


def run_tasks(policy, n_workers=4, n_tasks=200, attr_of=lambda i: i):
    sched = TaskScheduler(n_workers, policy)
    results = []
    lock = threading.Lock()

    def work(i):
        with lock:
            results.append(i)
        return i * 2

    tasks = [sched.spawn(work, i, attr=attr_of(i)) for i in range(n_tasks)]
    sched.wait_all()
    sched.shutdown()
    return sched, tasks, results


@pytest.mark.parametrize("make", [
    lambda: CilkPolicy(4), lambda: FifoPolicy(4),
    lambda: ClusteredPolicy(4, cluster_of=lambda a: a % 10),
    lambda: NearestNeighborPolicy(4, cluster_of=lambda a: a % 10)])
def test_all_tasks_run(make):
    _, tasks, results = run_tasks(make())
    assert sorted(results) == list(range(200))
    assert all(t.result == i * 2 for i, t in enumerate(tasks))


def test_clustered_steal_takes_whole_bucket():
    pol = ClusteredPolicy(2, cluster_of=lambda a: a)
    for _ in range(6):
        pol.put(0, Task(lambda: None, (), attr=7))
    assert len(pol.steal(1, 0)) == 6
    assert pol.approx_len(0) == 0


def test_cilk_steal_takes_one():
    pol = CilkPolicy(2)
    for _ in range(6):
        pol.put(0, Task(lambda: None, ()))
    assert len(pol.steal(1, 0)) == 1
    assert pol.approx_len(0) == 5


def test_clustered_get_drains_bucket_before_switching():
    pol = ClusteredPolicy(1, cluster_of=lambda a: a)
    for attr in [1, 2, 1, 2, 1, 3]:
        pol.put(0, Task(lambda: None, (), attr=attr))
    seen = [pol.get(0).attr for _ in range(6)]
    assert seen == [1, 1, 1, 2, 2, 3]
    assert pol.switches[0] == 3


def test_clustered_drains_deepest_then_hottest_first():
    pol = ClusteredPolicy(1, cluster_of=lambda a: a)
    pol.put(0, Task(lambda: None, (), attr="a", depth=1))
    pol.put(0, Task(lambda: None, (), attr="b", depth=3))
    pol.put(0, Task(lambda: None, (), attr="c", depth=2))
    assert [pol.get(0).attr for _ in range(3)] == ["b", "c", "a"]
    pol.put(0, Task(lambda: None, (), attr="cold", depth=5))
    pol.put(0, Task(lambda: None, (), attr="hot", priority=90.0))
    assert pol.get(0).attr == "hot"


def test_weighted_fair_drain():
    pol = ClusteredPolicy(1, cluster_of=lambda a: a)
    pol.set_weights({"a": 5.0, "b": 1.0})
    for i in range(4):
        pol.put(0, Task(lambda: None, (), attr=("a", i), tenant="a"))
    for i in range(4):
        pol.put(0, Task(lambda: None, (), attr=("b", i), tenant="b"))
    assert [pol.get(0).tenant for _ in range(8)] == ["a"] * 4 + ["b"] * 4
    assert pol.tenant_served() == {"a": 4, "b": 4}


def test_nn_drain_selects_max_overlap():
    pol = NearestNeighborPolicy(1, cluster_of=lambda a: a)
    pol.put(0, Task(lambda: None, (), attr=(5, 6)))
    assert pol.get(0).attr == (5, 6)
    pol.put(0, Task(lambda: None, (), attr=(7, 8)))
    pol.put(0, Task(lambda: None, (), attr=(5, 9)))
    assert pol.get(0).attr == (5, 9)


def test_spawn_from_worker_lands_on_spawning_worker():
    class SpyPolicy(CilkPolicy):
        def __init__(self, n):
            super().__init__(n)
            self.puts = []

        def put(self, worker, task):
            self.puts.append((worker, task.attr))
            super().put(worker, task)

    pol = SpyPolicy(3)
    sched = TaskScheduler(3, pol)
    ran_on = {}

    def parent():
        ran_on["worker"] = sched._tls.worker_id
        sched.spawn(lambda: None, attr="child", depth=1)

    sched.spawn(parent, attr="parent")
    sched.wait_all()
    sched.shutdown()
    assert [w for w, a in pol.puts if a == "child"] == [ran_on["worker"]]


def test_task_error_recorded_without_deadlock():
    sched = TaskScheduler(2, CilkPolicy(2))

    def boom(i):
        if i == 3:
            raise RuntimeError("kaboom")
        return i

    tasks = [sched.spawn(boom, i, attr=i) for i in range(6)]
    sched.wait_all()
    sched.shutdown()
    assert [t for t in tasks if t.error is not None] == [tasks[3]]
    s = sched.merged_stats()
    assert s["tasks_run"] == s["spawned"] == 6


def test_wait_all_reusable_and_worker_stats_merged():
    sched = TaskScheduler(4, make_policy("clustered", 4, lambda a: a))

    def body(rows):
        st = sched.worker_stats()
        st.rows_touched += rows
        st.bytes_swept += rows * 8
        return rows

    for wave in range(3):
        for i in range(50):
            sched.spawn(body, 3, attr=i % 7)
        sched.wait_all()
        s = sched.merged_stats()
        assert s["tasks_run"] == s["spawned"] == 50 * (wave + 1)
    sched.shutdown()
    s = sched.merged_stats()
    assert s["rows_touched"] == 450 and s["bytes_swept"] == 3600
    assert set(s) == set(rs.TaskScheduler(1, rs.CilkPolicy(1))
                         .merged_stats())


def test_make_policy_names():
    for name, cls in [("cilk", CilkPolicy), ("fifo", FifoPolicy),
                      ("clustered", ClusteredPolicy),
                      ("nn", NearestNeighborPolicy)]:
        assert isinstance(make_policy(name, 2), cls)
    with pytest.raises(ValueError):
        make_policy("nope", 2)


def test_stable_hash_and_placement_identical_to_reference():
    """The crc32 placement must match the reference's, so a task lands
    on the same worker (and so the same bucket mix) in both."""
    keys = [42, "prefix", ("a", 1), (3, (1, 2, 7)), -17]
    assert [ts.stable_hash(k) for k in keys] == \
        [rs.stable_hash(k) for k in keys]


@pytest.mark.parametrize("policy", ["cilk", "fifo", "clustered", "nn"])
def test_single_worker_drain_order_identical_to_reference(policy):
    """With one worker the run order is deterministic: the port's
    policies must run tasks in the reference's order."""
    rng = np.random.default_rng(1)
    attrs = [tuple(sorted(rng.choice(6, size=2, replace=False).tolist()))
             for _ in range(40)]
    orders = []
    for mod in (ts, rs):
        order = []
        pol = mod.make_policy(policy, 1, lambda a: a)
        sched = mod.TaskScheduler(1, pol)
        started, gate = threading.Event(), threading.Event()

        def hold():                           # hold the worker while
            started.set()                     # every task is queued
            assert gate.wait(timeout=30)

        sched.spawn(hold, attr=(9, 9))
        assert started.wait(timeout=30)
        for i, a in enumerate(attrs):
            sched.spawn(order.append, i, attr=a)
        gate.set()
        sched.wait_all()
        sched.shutdown()
        orders.append(order)
    assert orders[0] == orders[1] and len(orders[0]) == len(attrs)
