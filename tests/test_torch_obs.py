"""The port's tracer and exporters against the reference's: the cases of
``tests/test_obs.py`` run on ``repro_torch.obs``, the same synthetic
event lists through both packages give the same exports, the one known
divergence (an exactly-full ring) is pinned, and a traced CPU mine has
well-formed, complete timelines on both backends."""
import gc
import json
import threading

import numpy as np
import pytest
from _hyp import given, settings, st

from repro.core import fpm as rfpm
from repro.obs import export as rexport
from repro.obs import tracer as rtracer
from repro_torch.core import fpm as tfpm
from repro_torch.core import streaming as tstreaming
from repro_torch.core.tidlist import pack_database
from repro_torch.data.transactions import load
from repro_torch.obs import (Tracer, check_nesting, chrome_trace,
                             summary_table, time_in_state,
                             write_chrome_trace)
from repro_torch.obs import export as texport

try:
    from hypothesis import example
except ImportError:                      # the shim skips the property test
    def example(**kwargs):
        return lambda fn: fn


@pytest.fixture(scope="module")
def small_db():
    db, p = load("mushroom", seed=0)
    return [t for t in db[:300]], p


def _span(tr, name, t0, dt, cat="task"):
    """Synthesize a span with exact [t0, t0+dt] extent on the calling
    thread's ring (bypasses the wall clock for deterministic tests)."""
    tr._ring().append(("X", name, cat, t0, dt, None))


# ---------------------------------------------------------------- tracer --
def test_span_records_duration_and_args():
    tr = Tracer()
    t0 = tr.now()
    tr.span("work", t0, cat="task", args={"k": 1})
    (ev,) = tr.events()
    assert ev.ph == "X" and ev.name == "work" and ev.cat == "task"
    assert ev.dur >= 0.0 and ev.args == {"k": 1}


def test_ring_overflow_drops_oldest_without_corruption():
    tr = Tracer(ring_size=8)
    for i in range(20):
        _span(tr, f"s{i}", float(i), 0.5)
    evs = tr.events()
    assert [e.name for e in evs] == [f"s{i}" for i in range(12, 20)]
    assert all(e.dur == 0.5 for e in evs)
    assert tr.dropped() == 12
    assert "dropped" in str(chrome_trace(tr).get("otherData", {}))


def test_exactly_full_ring_keeps_every_event():
    """A ring that took exactly ``ring_size`` events returns all of them
    (the reference tracer returns none in this case)."""
    tr = Tracer(ring_size=8)
    for i in range(8):
        _span(tr, f"s{i}", float(i), 0.5)
    assert [e.name for e in tr.events()] == [f"s{i}" for i in range(8)]
    assert tr.dropped() == 0
    _span(tr, "s8", 8.0, 0.5)
    assert [e.name for e in tr.events()] == [f"s{i}" for i in range(1, 9)]
    assert tr.dropped() == 1


def test_ring_is_per_thread_and_lane_order_is_stable():
    tr = Tracer()
    tr.set_lane("driver", sort_index=0)
    _span(tr, "main", 0.0, 1.0)

    def worker(i):
        tr.set_lane(f"worker-{i}", sort_index=10 + i)
        _span(tr, f"w{i}", 0.0, 1.0)

    ts = [threading.Thread(target=worker, args=(i,)) for i in (1, 0)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
        assert not t.is_alive()
    # sort_index, not registration order, decides display order
    assert tr.lane_names() == ["driver", "worker-0", "worker-1"]


def test_disabled_fast_path_is_structural(small_db):
    db, p = small_db
    bm, counts = pack_database(db, p.n_dense_items, return_counts=True)
    res, met = tfpm.mine(bm, int(0.3 * len(db)), device="cpu",
                         policy="clustered", n_workers=2, max_k=4,
                         item_counts=counts)
    assert met.wall_s > 0


def test_ring_size_floor():
    with pytest.raises(ValueError, match="ring_size"):
        Tracer(ring_size=7)


# ------------------------------------------------------------- exporters --
def test_nesting_well_formed_and_violation_detected():
    tr = Tracer()
    _span(tr, "child", 1.0, 2.0)
    _span(tr, "parent", 0.0, 10.0)
    _span(tr, "after", 11.0, 1.0)
    assert check_nesting(tr.events()) == []
    _span(tr, "straddle", 11.5, 2.0)   # starts inside "after", ends past
    bad = check_nesting(tr.events())
    assert len(bad) == 1 and "straddle" in bad[0]


def test_time_in_state_bills_nested_child_to_its_own_category():
    tr = Tracer()
    tr.set_lane("worker-0", sort_index=10)
    _span(tr, "sweep", 2.0, 3.0, cat="sweep")
    _span(tr, "task", 0.0, 10.0, cat="task")
    _span(tr, "park", 10.0, 4.0, cat="idle")
    (row,) = time_in_state(tr).values()
    assert row["sweep"] == pytest.approx(3.0)
    assert row["eval"] == pytest.approx(7.0)      # 10 − nested 3
    assert row["idle"] == pytest.approx(4.0)
    assert row["total"] == pytest.approx(14.0)
    assert row["extent"] == pytest.approx(14.0)
    table = summary_table(tr, wall_s=14.0)
    assert "worker-0" in table and "100.0%" in table


def test_chrome_trace_json_round_trip(tmp_path):
    tr = Tracer()
    tr.set_lane("driver", sort_index=0, pid=3)
    _span(tr, "level-2", 0.25, 0.5, cat="level")
    tr.counter("refresh_lag", {"s": 0.125})
    path = str(tmp_path / "t.trace.json")
    write_chrome_trace(tr, path)
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    names = {e["ph"]: e for e in evs}
    assert {"M", "X", "C"} <= set(names)
    x = names["X"]
    assert x["ts"] == pytest.approx(0.25e6)       # µs
    assert x["dur"] == pytest.approx(0.5e6)
    assert x["pid"] == 3 and x["tid"] >= 1
    c = names["C"]
    assert c["args"] == {"s": 0.125}
    meta = [e for e in evs if e["ph"] == "M"]
    assert {"process_name", "thread_name", "thread_sort_index"} <= {
        m["name"] for m in meta}
    assert any(m["args"].get("name") == "host-3" for m in meta)


@settings(max_examples=25, deadline=None, database=None)
@given(st.lists(st.lists(st.integers(0, 7), min_size=1, max_size=30),
                min_size=1, max_size=4))
@example(lanes=[[0] * 8])
def test_merged_timeline_preserves_per_lane_order(lanes):
    """Property: events() merges rings lane by lane, and within every
    lane the collected order IS the append order — even across ring
    overflow, and for a ring that took exactly its capacity."""
    tr = Tracer(ring_size=8)

    def emit(i, seq):
        tr.set_lane(f"lane-{i}", sort_index=i)
        for j, _ in enumerate(seq):
            _span(tr, f"{i}:{j}", float(j), 0.5)

    threads = [threading.Thread(target=emit, args=(i, seq))
               for i, seq in enumerate(lanes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    by_lane = {}
    for ev in tr.events():
        by_lane.setdefault(ev.lane, []).append(ev.name)
    assert len(by_lane) == len(lanes)
    for i, seq in enumerate(lanes):
        got = [int(n.split(":")[1]) for n in by_lane[f"lane-{i}"]]
        want = list(range(len(seq)))[-8:]          # drop-oldest suffix
        assert got == want


# ------------------------------------------- parity with the reference --
def _lanes(seed, cap):
    """Seeded synthetic lanes: (name, pid, sort, events), each lane with
    nested and disjoint spans, a straddling span now and then, instants
    and counters; event counts below, and far above, ``cap`` but never
    exactly ``cap``."""
    rng = np.random.default_rng(seed)
    cats = ["task", "sweep", "flush", "idle", "steal", "level", "arena",
            "span"]
    lanes = []
    for li in range(int(rng.integers(1, 5))):
        evs, t = [], 0.0
        n = int(rng.choice([cap - 3, cap + 5, 3 * cap + 1]))
        while len(evs) < n:
            kind = rng.random()
            dur = float(rng.integers(1, 100)) / 64
            if kind < 0.55:
                # parent span with one nested child, child recorded first
                evs.append(("X", "child", cats[int(rng.integers(8))],
                            t + dur / 4, dur / 2, None))
                evs.append(("X", "parent", cats[int(rng.integers(8))],
                            t, dur, {"k": len(evs)}))
                if rng.random() < 0.1:     # a straddle past the parent
                    evs.append(("X", "straddle", "task", t + dur / 2,
                                dur, None))
            elif kind < 0.8:
                evs.append(("I", "h2d", "arena", t, 0.0,
                            {"bytes": int(rng.integers(1, 1 << 20))}))
            else:
                evs.append(("C", "lag", "counter", t, 0.0,
                            {"s": float(rng.random())}))
            t += dur * 1.5
        evs = evs[:n]
        if len(evs) == cap:
            evs = evs[:-1]
        lanes.append((f"lane-{li}", int(rng.integers(0, 2)),
                      int(rng.integers(0, 20)) if rng.random() < 0.7
                      else None, evs))
    return lanes


def _feed(tracer_cls, lanes, cap):
    tr = tracer_cls(ring_size=cap)
    for name, pid, sort, evs in lanes:
        ring = tr._new_ring(name, pid, sort)
        for ev in evs:
            ring.append(ev)
    return tr


@pytest.mark.parametrize("seed", range(6))
def test_exports_equal_reference_on_the_same_events(seed):
    cap = 16
    lanes = _lanes(seed, cap)
    ref = _feed(rtracer.Tracer, lanes, cap)
    port = _feed(Tracer, lanes, cap)
    assert port.events() == ref.events()
    assert port.dropped() == ref.dropped()
    assert port.lanes() == ref.lanes()
    assert texport.chrome_trace(port) == rexport.chrome_trace(ref)
    assert texport.check_nesting(port.events()) == \
        rexport.check_nesting(ref.events())
    assert texport.time_in_state(port) == rexport.time_in_state(ref)
    assert texport.summary_table(port, 3.0) == \
        rexport.summary_table(ref, 3.0)
    assert texport.STATE_OF_CAT == rexport.STATE_OF_CAT


def test_exactly_full_ring_is_the_known_divergence():
    """The reference's ``_Ring.snapshot`` returns nothing for a ring that
    took exactly ``cap`` events, so its exports lose that lane's events;
    the port keeps them. Every other lane exports alike."""
    cap = 8
    full = ("full", 0, 1, [("X", f"s{i}", "task", float(i), 0.5, None)
                           for i in range(cap)])
    short = ("short", 0, 2, [("X", "t", "task", 0.0, 1.0, None)])
    ref = _feed(rtracer.Tracer, [full, short], cap)
    port = _feed(Tracer, [full, short], cap)
    assert [e.lane for e in ref.events()] == ["short"]
    assert [e.lane for e in port.events()] == ["full"] * cap + ["short"]
    assert [e.name for e in port.events()][:cap] == [
        f"s{i}" for i in range(cap)]
    rows = {r["lane"]: r for r in texport.time_in_state(port).values()}
    assert rows["full"]["eval"] == pytest.approx(cap * 0.5)
    assert {r["lane"] for r in rexport.time_in_state(ref).values()} == {
        "short"}
    assert rows["short"] == next(iter(rexport.time_in_state(ref).values()))


# ---------------------------------------------------- traced engine runs --
@pytest.mark.parametrize("granularity", ["bucket", "depth-first"])
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_traced_mine_matches_untraced_and_covers_workers(small_db, backend,
                                                         granularity):
    """A traced CPU mine gives the untraced run's and the reference's
    supports, a Perfetto-loadable trace with driver, dispatcher and one
    lane per worker, well-formed nesting, and per-worker time-in-state
    that tiles each worker's extent to within 5%."""
    db, p = small_db
    bm, counts = pack_database(db, p.n_dense_items, return_counts=True)
    ms = int(0.3 * len(db))
    kw = dict(policy="clustered", n_workers=4, max_k=4,
              granularity=granularity, item_counts=counts)
    ref, _ = tfpm.mine(bm, ms, device="cpu", backend=backend, **kw)
    want, _ = rfpm.mine(bm, ms, backend="numpy", **kw)
    tr = Tracer()
    res, met = tfpm.mine(bm, ms, device="cpu", backend=backend, trace=tr,
                         **kw)
    assert res == ref == want                      # tracing is inert
    names = tr.lane_names()
    workers = [n for n in names if n.startswith("worker-")]
    assert len(workers) == 4 and "driver" in names
    assert "dispatcher-0" in names
    assert tr.dropped() == 0
    spans = [e for e in tr.events() if e.ph == "X"]
    cats = {e.cat for e in spans}
    want_cats = {"task", "sweep"}
    if granularity == "bucket":
        want_cats |= {"level", "flush"}
    if backend == "torch":
        want_cats |= {"flush", "arena"}            # mirror syncs
    assert want_cats <= cats, cats
    assert any(e.cat in ("steal", "idle") for e in spans)
    assert check_nesting(tr.events()) == []
    per_worker = {e.lane for e in spans if e.cat == "task"}
    if granularity == "bucket":
        assert per_worker >= set(workers)          # every worker ran tasks
    else:
        # a few deep classes: not every worker need get one
        assert per_worker and per_worker <= set(workers)
        assert max(e.args["depth"] for e in spans if e.cat == "task") > 0
    for row in time_in_state(tr).values():
        if not row["lane"].startswith("worker-"):
            continue
        assert row["total"] >= 0.95 * row["extent"] - 0.002, row
        assert row["total"] <= row["extent"] + 1e-6, row
    doc = chrome_trace(tr)
    lanes_with_tasks = {(e["pid"], e["tid"]) for e in doc["traceEvents"]
                       if e.get("cat") == "task"}
    assert len(lanes_with_tasks) == len(per_worker)
    json.dumps(doc)


def test_traced_flush_spans_describe_their_batch(small_db):
    db, p = small_db
    bm, counts = pack_database(db, p.n_dense_items, return_counts=True)
    tr = Tracer()
    _, met = tfpm.mine(bm, int(0.3 * len(db)), device="cpu",
                       backend="torch", n_workers=3, max_k=3,
                       item_counts=counts, trace=tr)
    flushes = [e for e in tr.events() if e.name == "flush"]
    assert len(flushes) == met.flushes
    assert {e.lane for e in flushes} == {"dispatcher-0"}
    assert sum(e.args["requests"] for e in flushes) == sum(
        d["sweep_requests"] for d in met.per_device)
    for e in flushes:
        a = e.args
        assert a["sparse"] + a["dense"] == a["requests"]
    # one serial id per flush span
    assert len({e.args["flush"] for e in flushes}) == len(flushes)
    syncs = [e for e in tr.events() if e.name == "h2d-sync"]
    assert syncs and all(e.cat == "arena" for e in syncs)
    # the load upload and every later sync bill what the spans carry
    assert sum(e.args["bytes"] for e in syncs) + sum(
        e.args["bytes"] for e in tr.events() if e.name == "h2d") == \
        met.h2d_bytes
    levels = [e for e in tr.events() if e.cat == "level"]
    assert [e.name for e in levels] == [f"level-{k}"
                                        for k in range(2, 2 + met.levels)]
    assert {e.lane for e in levels} == {"driver"}


# ------------------------------------------- host work that idles the card --
def _traced_bucket_mine(small_db):
    """A traced kernel-backend bucket mine with two levels, the second
    over prefixes the workers build."""
    db, p = small_db
    bm, counts = pack_database(db, p.n_dense_items, return_counts=True)
    tr = Tracer()
    res, met = tfpm.mine(bm, int(0.2 * len(db)), device="cpu",
                         backend="torch", n_workers=3, max_k=3,
                         item_counts=counts, trace=tr)
    return tr, res, met


def _inside(child, parent):
    return (parent.ts <= child.ts
            and child.ts + child.dur <= parent.ts + parent.dur + 1e-9)


def test_traced_mine_records_arena_build_items_and_level_planning(
        small_db):
    """The driver lane holds the arena build and level 1, and under every
    ``level-k`` span exactly one ``candidates``, ``plan`` and
    ``collect`` child, each in the host category (no time-in-state
    state); nothing straddles."""
    tr, _, met = _traced_bucket_mine(small_db)
    driver = [e for e in tr.events() if e.lane == "driver" and e.ph == "X"]
    names = [e.name for e in driver]
    assert names.count("arena-build") == names.count("items") == 1
    build = next(e for e in driver if e.name == "arena-build")
    items = next(e for e in driver if e.name == "items")
    levels = [e for e in driver if e.name.startswith("level-")]
    assert len(levels) == met.levels >= 2
    assert build.ts + build.dur <= items.ts <= levels[0].ts
    for lv in levels:
        kids = [e.name for e in driver if e is not lv and _inside(e, lv)]
        assert sorted(kids) == ["candidates", "collect", "plan"], kids
        plan = next(e for e in driver if e.name == "plan" and _inside(e, lv))
        assert plan.args["candidates"] == lv.args["candidates"]
        assert plan.args["buckets"] > 0
    assert {e.cat for e in driver if not e.name.startswith("level-")} == {
        tfpm.HOST_CAT}
    assert tfpm.HOST_CAT not in texport.STATE_OF_CAT
    assert check_nesting(tr.events()) == []


def test_bucket_collect_builds_tuples_for_frequent_itemsets_only(
        small_db):
    """On the bucket path each level's counts are thresholded in bulk:
    the ``collect`` span's ``tuples`` equals its ``frequent``, not its
    ``candidates``, and the mine still equals ``mine_serial``."""
    db, p = small_db
    tr, res, met = _traced_bucket_mine(small_db)
    collects = [e for e in tr.events()
                if e.lane == "driver" and e.name == "collect"]
    assert len(collects) == met.levels >= 2
    for e in collects:
        assert e.args["tuples"] == e.args["frequent"]
    # the mechanism is visible: some level counted more than it kept
    assert any(e.args["candidates"] > e.args["tuples"] for e in collects)
    assert sum(e.args["candidates"] for e in collects) == met.candidates
    bm = pack_database(db, p.n_dense_items)
    assert res == tfpm.mine_serial(bm, int(0.2 * len(db)), max_k=3)


def test_worker_sweeps_name_the_flush_that_answered(small_db):
    tr, _, _ = _traced_bucket_mine(small_db)
    evs = tr.events()
    flushes = {e.args["flush"]: e for e in evs if e.name == "flush"}
    sweeps = [e for e in evs
              if e.name == "sweep" and e.lane.startswith("worker-")]
    assert sweeps
    for e in sweeps:
        f = flushes[e.args["flush"]]
        assert e.args["queued_s"] >= 0
        # the flush starts after the request was made and ends before
        # the caller wakes
        assert e.ts <= f.ts and f.ts + f.dur <= e.ts + e.dur + 1e-9
    launches = [e for e in evs if e.name == "launch"]
    assert launches and {e.lane for e in launches} == {"dispatcher-0"}
    assert all(any(_inside(x, f) for f in flushes.values())
               for x in launches)
    assert {e.args["kernel"] for e in launches} <= {
        "bitmap_join_many", "gather_intersect_many"}


def test_worker_sweep_state_is_the_sum_of_sweep_spans(small_db):
    """Prefix builds are worker-lane spans of their own, billed to no
    sweep state: the workers' blocked time stays their sweep spans."""
    tr, _, met = _traced_bucket_mine(small_db)
    evs = tr.events()
    prefixes = [e for e in evs if e.name == "prefix"]
    assert prefixes and met.cache_misses >= len(prefixes)
    assert all(e.lane.startswith("worker-") for e in prefixes)
    assert all(e.args["rows_read"] >= 1 and e.args["rep"] in (
        "bitmap", "tidlist") for e in prefixes)
    for row in time_in_state(tr).values():
        if not row["lane"].startswith("worker-"):
            continue
        spans = sum(e.dur for e in evs if e.lane == row["lane"]
                    and e.ph == "X" and e.cat == "sweep")
        assert row["sweep"] == pytest.approx(spans, abs=1e-9)


def test_forced_collection_lands_on_the_gc_lane(small_db, monkeypatch):
    before = list(gc.callbacks)
    inside = []
    gen = tfpm.gen_buckets

    def collecting(*args, **kw):
        inside.append(len(gc.callbacks))
        gc.collect()
        return gen(*args, **kw)

    monkeypatch.setattr(tfpm, "gen_buckets", collecting)
    tr, _, _ = _traced_bucket_mine(small_db)
    assert gc.callbacks == before
    assert inside and set(inside) == {len(before) + 1}
    spans = [e for e in tr.events() if e.name == "gc"]
    assert {e.lane for e in spans} == {"gc"} and {e.cat for e in spans} == {
        "gc"}
    full = [e for e in spans if e.args["generation"] == 2]
    assert full and all(e.args["collected"] >= 0 for e in full)
    assert threading.current_thread().name in {e.args["thread"]
                                              for e in full}
    assert check_nesting(tr.events()) == []


def test_untraced_mine_installs_no_gc_callback(small_db, monkeypatch):
    before = list(gc.callbacks)
    inside = []
    gen = tfpm.gen_buckets

    def counting(*args, **kw):
        inside.append(list(gc.callbacks))
        return gen(*args, **kw)

    monkeypatch.setattr(tfpm, "gen_buckets", counting)
    db, p = small_db
    bm, counts = pack_database(db, p.n_dense_items, return_counts=True)
    tfpm.mine(bm, int(0.3 * len(db)), device="cpu", backend="torch",
              n_workers=3, max_k=3, item_counts=counts)
    assert inside and all(cb == before for cb in inside)
    assert gc.callbacks == before


def test_gc_hook_nests_and_leaves_no_reference():
    import weakref
    before = list(gc.callbacks)
    tr = Tracer()
    tr.hook_gc()
    tr.hook_gc()
    assert len(gc.callbacks) == len(before) + 1
    tr.unhook_gc()
    gc.collect()
    assert len(gc.callbacks) == len(before) + 1
    tr.unhook_gc()
    assert gc.callbacks == before
    assert [e.lane for e in tr.events()] == ["gc"]
    ref = weakref.ref(tr)
    del tr
    assert ref() is None


def _stream_rows(n, items=16, seed=7):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(items, size=rng.integers(2, 7),
                              replace=False).tolist()) for _ in range(n)]


@pytest.mark.parametrize("host", ["miner", "tenant"])
def test_traced_refresh_records_its_delta_bookkeeping(host):
    """Both refresh methods record the dirty-item popcount, the
    ``drop_unswept`` pass (a fraction threshold) and the assembly on the
    refreshing lane, the delta chunks' blocked time as worker ``sweep``
    spans, and the ingests' and refreshes' collections only while they
    run."""
    rows = _stream_rows(400)
    tr = Tracer()
    before = list(gc.callbacks)
    kw = dict(device="cpu", backend="torch", n_workers=3, max_k=4,
              tracer=tr)
    if host == "miner":
        owner = stream = tstreaming.StreamingMiner(
            16, 0.1, initial_db=rows[:300], **kw)
    else:
        owner = tstreaming.TenantHub(16, **kw)
        stream = owner.tenant("t", 0.1)
        stream.ingest(rows[:300])
    try:
        stream.refresh()
        stream.ingest(rows[300:])
        rep = stream.refresh()
    finally:
        owner.close()
    assert gc.callbacks == before
    assert rep.swept_delta > 0
    evs = tr.events()
    refreshing = {e.lane for e in evs if e.name == "dirty-items"}
    assert refreshing == {"driver"}
    names = [e.name for e in evs if e.lane == "driver"]
    assert names.count("dirty-items") == names.count("assemble") == 2
    assert names.count("drop-unswept") == 2
    drops = [e for e in evs if e.name == "drop-unswept"]
    assert all(e.args["known"] >= e.args["dropped"] >= 0 for e in drops)
    sweeps = [e for e in evs if e.name == "sweep"
              and e.lane.startswith("worker-") and "requests" in e.args]
    assert sweeps and all(e.args["queued_s"] >= 0 for e in sweeps)
    flush_ids = {e.args["flush"] for e in evs if e.name == "flush"}
    assert {e.args["flush"] for e in sweeps} <= flush_ids
    assert check_nesting(evs) == []


def test_traced_stream_refresh_builds_tuples_for_published_itemsets_only():
    """A fraction-threshold refresh at bucket grain classifies, folds and
    thresholds each level by masks over the known store's arrays: level
    2's ``collect`` builds a tuple per frequent candidate only, ``plan``
    builds none, and ``assemble`` materialises just the itemsets the
    snapshot publishes (the border stays a view)."""
    rows = _stream_rows(400)
    tr = Tracer()
    sm = tstreaming.StreamingMiner(16, 0.1, initial_db=rows[:300],
                                   device="cpu", backend="torch",
                                   n_workers=3, max_k=4, tracer=tr,
                                   granularity="bucket")
    snaps = []
    try:
        for batch in (None, rows[300:350], rows[350:]):
            if batch is not None:
                sm.ingest(batch)
            rep = sm.refresh()
            snaps.append(sm.snapshot)
    finally:
        sm.close()
    assert rep.swept_delta > 0
    driver = [e for e in tr.events() if e.lane == "driver" and e.ph == "X"]
    level2 = [e for e in driver if e.name == "level-2"]
    assert len(level2) == 3
    collects = [next(e for e in driver if e.name == "collect"
                     and _inside(e, lv)) for lv in level2]
    plans = [next(e for e in driver if e.name == "plan" and _inside(e, lv))
             for lv in level2]
    for c in collects:
        assert c.args["tuples"] == c.args["frequent"]
    # the mechanism is visible: level 2 counted more than it kept
    assert all(c.args["candidates"] > c.args["tuples"] for c in collects)
    assert sum(p.args["dirty"] for p in plans) > 0
    assert all(e.args["tuples"] == 0 for e in driver if e.name == "plan")
    assembles = [e for e in driver if e.name == "assemble"]
    assert [e.args["tuples"] for e in assembles] == [
        len(s.supports) for s in snaps]
    assert [e.args["border"] for e in assembles] == [
        len(s.border) for s in snaps]
