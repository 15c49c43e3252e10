"""The port's batch mining end to end against the reference engine on
the same inputs — supports and every deterministic gauge, at bucket,
candidate, depth-first and auto granularity — plus the device rule, the
mesh entry points, and the rule that the port imports neither JAX nor
the reference package."""
import ast
import itertools
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro.core import fpm as rfpm
from repro.core import tidlist as rtl
from repro.core import streaming as rs
from repro.core.streaming import StreamingMiner as RStreamingMiner
from repro.launch import fpm_mine as rlaunch
from repro_torch.core import fpm as tfpm
from repro_torch.core import join_backend as tjb
from repro_torch.core import streaming as ts
from repro_torch.core.streaming import StreamingMiner, TenantHub
from repro_torch.core.tidlist import BitmapArena, pack_database
from repro_torch.data import transactions as tt
from repro_torch.launch import fpm_mine

ROOT = Path(__file__).resolve().parents[1]
GAUGES = ("rows_touched", "bytes_swept", "dense_sweeps", "sparse_sweeps",
          "h2d_bytes", "flushes", "buckets", "candidates", "levels",
          "frequent", "sparse_rows", "sparsify_ops", "densify_ops",
          "sparse_bytes_swept", "cache_hits", "cache_misses",
          "peak_retained_bitmaps")


def cut(profile, n_tx, support):
    """The first ``n_tx`` transactions of a profile, packed, with an
    absolute min support of ``support`` × n_tx."""
    db, p = tt.load(profile, 0)
    db = db[:n_tx]
    n_items = p.n_items if p.kind == "quest" else p.n_dense_items
    bm, counts = pack_database(db, n_items, return_counts=True)
    return bm, counts, max(1, int(support * len(db)))


# retail: a sparse long tail, so prefixes go tid-list (sparse sweeps);
# mushroom: dense, every sweep takes the bitmap kernel
CASES = {"retail": ("retail", 1000, 0.03, 3),
         "mushroom": ("mushroom", 8124, 0.20, 2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_backend_equals_reference_engine(case):
    """One worker makes every flush a single request, so the schedule is
    fixed and every gauge must match the reference's pallas-interpret
    run exactly."""
    profile, n_tx, support, max_k = CASES[case]
    bm, counts, ms = cut(profile, n_tx, support)
    got, gm = tfpm.mine(bm, ms, device="cpu", backend="torch",
                        n_workers=1, max_k=max_k, item_counts=counts)
    want, wm = rfpm.mine(bm, ms, backend="pallas-interpret", n_workers=1,
                         max_k=max_k, item_counts=counts)
    assert got == want
    for g in GAUGES:
        assert getattr(gm, g) == getattr(wm, g), g
    assert gm.rep_picks == wm.rep_picks
    if case == "retail":
        assert gm.sparse_sweeps > 0 and gm.dense_sweeps > 0
    else:
        assert gm.sparse_sweeps == 0 and gm.dense_sweeps > 0


@pytest.mark.parametrize("policy", ["clustered", "cilk"])
@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_four_workers_match_reference_numpy_engine(policy, backend):
    bm, counts, ms = cut("retail", 1000, 0.03)
    got, gm = tfpm.mine(bm, ms, device="cpu", backend=backend,
                        policy=policy, n_workers=4, max_k=3)
    want, wm = rfpm.mine(bm, ms, backend="numpy", policy=policy,
                         n_workers=4, max_k=3)
    assert got == want == tfpm.mine_serial(bm, ms, max_k=3)
    # the work done is schedule-independent at bucket grain
    for g in ("buckets", "candidates", "dense_sweeps", "sparse_sweeps"):
        assert getattr(gm, g) == getattr(wm, g), g
    assert gm.batch_occupancy >= 1.0


@pytest.mark.parametrize("rep", ["bitmap", "sparse"])
def test_candidate_granularity_and_forced_representations(rep):
    bm, counts, ms = cut("mushroom", 1200, 0.25)
    for gran in ("bucket", "candidate"):
        got, gm = tfpm.mine(bm, ms, device="cpu", granularity=gran,
                            representation=rep, n_workers=1, max_k=3)
        want, wm = rfpm.mine(bm, ms, backend="numpy", granularity=gran,
                             representation=rep, n_workers=1, max_k=3)
        assert got == want
        for g in ("rows_touched", "bytes_swept", "dense_sweeps",
                  "sparse_sweeps", "cache_hits"):
            assert getattr(gm, g) == getattr(wm, g), (gran, g)
    if rep == "bitmap":
        assert gm.sparse_sweeps == 0 and not gm.rep_picks


# ------------------------------------------------- depth-first and auto
@pytest.mark.parametrize("granularity", ["depth-first", "auto"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_class_engines_on_kernel_backend_equal_reference(case,
                                                         granularity):
    """The arena handoff path (materialize / tid-list / diffset rows,
    every class sweep a dispatcher request) against the reference's
    pallas-interpret run: one worker fixes the schedule, so supports,
    every gauge and the density model's picks agree exactly."""
    profile, n_tx, support, max_k = CASES[case]
    bm, counts, ms = cut(profile, n_tx, support)
    got, gm = tfpm.mine(bm, ms, device="cpu", backend="torch",
                        granularity=granularity, n_workers=1,
                        max_k=max_k, item_counts=counts)
    want, wm = rfpm.mine(bm, ms, backend="pallas-interpret",
                         granularity=granularity, n_workers=1,
                         max_k=max_k, item_counts=counts)
    assert got == want
    for g in GAUGES:
        assert getattr(gm, g) == getattr(wm, g), g
    assert gm.rep_picks == wm.rep_picks
    if case == "retail":
        assert gm.sparse_sweeps > 0 and gm.sparse_rows > 0


@pytest.mark.parametrize("granularity", ["depth-first", "auto"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_class_engines_on_numpy_backend_equal_reference(case, granularity):
    """The host backend's projected sparse subtrees: class sweeps run
    inline on the worker, and depth-first pushes no sparse arena row."""
    profile, n_tx, support, max_k = CASES[case]
    bm, counts, ms = cut(profile, n_tx, support)
    got, gm = tfpm.mine(bm, ms, device="cpu", backend="numpy",
                        granularity=granularity, n_workers=1,
                        max_k=max_k, item_counts=counts)
    want, wm = rfpm.mine(bm, ms, backend="numpy", granularity=granularity,
                         n_workers=1, max_k=max_k, item_counts=counts)
    assert got == want
    for g in GAUGES:
        assert getattr(gm, g) == getattr(wm, g), g
    assert gm.rep_picks == wm.rep_picks
    if granularity == "depth-first":
        assert gm.sparse_rows == 0
    if case == "retail":
        assert gm.sparse_sweeps > 0


def rand_db(n_tx, n_items, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    return [list(rng.choice(n_items, size=rng.integers(lo, hi),
                            replace=False)) for _ in range(n_tx)]


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("granularity,representation", list(
    itertools.product(("bucket", "depth-first", "auto"),
                      ("bitmap", "sparse", "auto"))))
def test_granularity_representation_matrix_equals_serial(
        granularity, representation, backend):
    """Every granularity × representation cell mines the frequent set of
    ``mine_serial`` at 3 workers; the database reaches k=4, so class
    tasks hand rows down."""
    db = rand_db(600, n_items=12, lo=3, hi=9)
    bm, counts = pack_database(db, 12, return_counts=True)
    want = tfpm.mine_serial(bm, 40, max_k=5)
    assert max(len(c) for c in want) >= 4
    got, met = tfpm.mine(bm, 40, device="cpu", backend=backend,
                         n_workers=3, max_k=5, granularity=granularity,
                         representation=representation, item_counts=counts)
    assert got == want
    if representation == "bitmap":
        assert met.sparse_sweeps == 0 and not met.rep_picks
    if representation == "sparse":
        assert met.sparse_sweeps > 0 and met.sparse_bytes_swept > 0
    assert met.flushes * met.batch_occupancy == pytest.approx(
        sum(d["sweep_requests"] for d in met.per_device))


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_depth_first_handoff_makes_cache_vestigial(backend):
    bm, counts, ms = cut("retail", 1000, 0.03)
    got, met = tfpm.mine(bm, ms, device="cpu", backend=backend,
                         n_workers=3, max_k=4, granularity="depth-first",
                         item_counts=counts)
    assert got == tfpm.mine_serial(bm, ms, max_k=4)
    assert met.cache_hits == met.cache_misses == 0
    assert met.peak_retained_bitmaps > 0 and met.peak_bytes_retained > 0
    assert met.buckets == met.scheduler["tasks_run"]


def _child_bomb(base):
    """A backend that fails every flush holding a child class's sweep:
    child classes are exactly the requests whose prefix is a handoff
    row (handle >= n_base)."""
    class ChildBomb(base):
        def sweep_many(self, arena, requests):
            if any(r.prefix_handle >= arena.n_base for r in requests):
                raise RuntimeError("child boom")
            return super().sweep_many(arena, requests)
    return ChildBomb()


@pytest.mark.parametrize("granularity", ["depth-first", "auto"])
@pytest.mark.parametrize("backend", [tjb.TorchBackend, tjb.NumpyBackend])
def test_child_task_error_surfaces_and_releases_every_row(
        monkeypatch, backend, granularity):
    """A child class's error reaches the caller instead of deadlocking
    the terminal wait, and no handoff row leaks: after the run closes
    the arena holds no row beyond the pinned items."""
    monkeypatch.setattr(tfpm, "resolve_backend",
                        lambda spec: _child_bomb(backend))
    bm, counts, ms = cut("mushroom", 1200, 0.25)
    store = BitmapArena.from_bitmaps(bm, device="cpu")
    result, frequent = tfpm._level1(bm, ms, counts=counts)
    run = tfpm.MiningRun(store, policy="clustered", n_workers=3,
                         granularity=granularity, cache_size=32,
                         item_counts=counts)
    with pytest.raises(RuntimeError, match="child boom"):
        try:
            tfpm.mine_more(run, ms, 4, result, frequent)
        finally:
            run.close()
    assert store.live_extra == 0 and store.peak_live_extra > 0


@pytest.mark.parametrize("granularity", tfpm.GRANULARITIES)
def test_finished_mine_frees_its_arena_without_the_cycle_collector(
        granularity, monkeypatch):
    """A returned mine leaves nothing in a reference cycle that holds its
    arena: the arena, and with it the device mirror, goes by reference
    counting, not at the next full collection."""
    import gc
    import weakref
    arenas = []
    build = BitmapArena.from_bitmaps.__func__

    def tracked(cls, *a, **kw):
        store = build(cls, *a, **kw)
        arenas.append(weakref.ref(store))
        return store

    monkeypatch.setattr(BitmapArena, "from_bitmaps", classmethod(tracked))
    bm, counts, ms = cut("retail", 400, 0.03)
    gc.collect()
    gc.disable()
    try:
        tfpm.mine(bm, ms, device="cpu", backend="torch", n_workers=3,
                  max_k=3, item_counts=counts, granularity=granularity)
        assert len(arenas) == 1 and arenas[0]() is None
    finally:
        gc.enable()


def test_mine_serial_equals_reference():
    bm, _, ms = cut("chess", 600, 0.7)
    assert tfpm.mine_serial(bm, ms, max_k=4) == \
        rfpm.mine_serial(bm, ms, max_k=4)


# ----------------------------------------------------------- device rule
def test_mine_without_device_raises_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bm = np.ones((3, 2), np.uint32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.mine(bm, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.mine(bm, 1, device="cuda", backend="numpy")


def _mesh_stream(mod, db, **kw):
    """Supports after a refresh, an ingest and a second refresh of a
    two-shard ``StreamingMiner`` on ``mod``."""
    kw = {"device": "cpu", **kw} if mod is ts else {"backend": "numpy",
                                                      **kw}
    sm = mod.StreamingMiner(12, 20, initial_db=db[:150], n_workers=3,
                            max_k=4, mesh=2, **kw)
    try:
        sm.refresh()
        sm.ingest(db[150:])
        rep = sm.refresh()
        assert sm.arena.n_shards == 2 and rep.d2d_bytes >= 0
        return dict(sm.snapshot.supports)
    finally:
        sm.close()


def _mesh_hub(mod, db):
    """Each tenant's final snapshot on a two-shard ``TenantHub``."""
    kw = {"device": "cpu"} if mod is ts else {"backend": "numpy"}
    with mod.TenantHub(12, n_workers=3, max_k=4, mesh=2, **kw) as hub:
        out = {}
        for tid, part in (("a", db[:120]), ("b", db[120:])):
            t = hub.tenant(tid, 15)
            t.ingest(part[:80])
            t.refresh()
            t.ingest(part[80:])
            t.refresh()
            out[tid] = dict(t.snapshot.supports)
        assert hub.arena.n_shards == 2
        return out


@pytest.mark.parametrize("kwargs", [
    {"mesh": 2}, {"hosts": 2, "mesh": 2}, {"stream_mesh": 2},
    {"hub_mesh": 2}, {"launcher_mesh": 2}])
def test_mesh_entry_points_match_reference(kwargs, capsys, monkeypatch):
    """The mesh entry points, which raised before the multi-device slice,
    run on the CPU and give the reference's results: a batch mine, a
    streaming miner, a tenant hub and the launcher's --mesh; hosts with
    mesh raise the reference's ValueError."""
    rng = np.random.default_rng(5)
    db = [sorted(rng.choice(12, size=rng.integers(2, 6),
                            replace=False).tolist()) for _ in range(240)]
    bm = pack_database(db, 12)
    if "stream_mesh" in kwargs:
        got = _mesh_stream(ts, db)
        assert got == _mesh_stream(rs, db)
        assert got == rfpm.mine_serial(bm, 20, max_k=4)
        for mod, kw in ((ts, {"device": "cpu"}), (rs, {})):
            with pytest.raises(ValueError, match="mutually exclusive"):
                mod.StreamingMiner(12, 1, mesh=2, hosts=2, **kw)
    elif "hub_mesh" in kwargs:
        got = _mesh_hub(ts, db)
        assert got == _mesh_hub(rs, db)
        for tid, part in (("a", db[:120]), ("b", db[120:])):
            assert got[tid] == rfpm.mine_serial(pack_database(part, 12), 15,
                                                max_k=4)
    elif "launcher_mesh" in kwargs:
        args = ["--dataset", "chess", "--max-k", "2", "--workers", "2",
                "--policies", "clustered", "--mesh", "2"]
        monkeypatch.setattr(sys, "argv", ["fpm_mine", *args, "--backend",
                                          "numpy"])
        rlaunch.main()
        want = capsys.readouterr().out
        fpm_mine.main([*args, "--device", "cpu"])
        got = capsys.readouterr().out
        line = "mesh: 2 device shards (logical)"
        assert line in got.splitlines() and line in want.splitlines()
        assert re.search(r"frequent=\d+ .*d2d=0B migrations=0 dev_occ=",
                         got)
    elif "hosts" in kwargs:
        for mine in (tfpm.mine, rfpm.mine):
            with pytest.raises(ValueError, match="mutually exclusive"):
                mine(bm, 1, **kwargs,
                     **({"device": "cpu"} if mine is tfpm.mine else {}))
    else:
        got, met = tfpm.mine(bm, 20, device="cpu", n_workers=3, max_k=4,
                             **kwargs)
        want, wmet = rfpm.mine(bm, 20, n_workers=3, max_k=4,
                               backend="numpy", **kwargs)
        assert got == want == rfpm.mine_serial(bm, 20, max_k=4)
        assert met.n_devices == wmet.n_devices == 2
        assert len(met.per_device) == 2


@pytest.mark.parametrize("granularity", ["bucket", "depth-first"])
def test_mine_more_delta_equals_reference(granularity):
    """``mine_more(delta=)`` on a two-segment arena: the same plan
    (known supports of the first segment, the second pending) gives the
    reference's supports, known-store updates and plan counters."""
    db, p = tt.load("retail", 0)
    db = db[:600]
    bm0 = pack_database(db[:590], p.n_items)
    bm1 = pack_database(db[590:], p.n_items)
    full, counts = pack_database(db, p.n_items, return_counts=True)
    ms, max_k = 15, 3
    # the known store of a refresh over the first segment: frequent
    # itemsets and the negative border
    rsm = RStreamingMiner(p.n_items, ms, initial_db=db[:590], max_k=max_k,
                          n_workers=1)
    rsm.refresh()
    known = dict(rsm._known)
    rsm.close()
    dirty = frozenset(int(i) for i in np.nonzero(
        rtl.popcount32(bm1).sum(axis=1))[0])
    out = []
    for mod, arena in ((tfpm, BitmapArena.from_bitmaps(bm0, device="cpu")),
                       (rfpm, rtl.BitmapArena.from_bitmaps(bm0))):
        arena.add_segment(bm1)
        plan = mod.DeltaPlan(known=dict(known), dirty_items=dirty,
                             segments=(1,), base_segments=(0, 1),
                             priority_of=lambda pre: 1.0)
        result, frequent = mod._level1(full, ms, counts=counts)
        kw = {"backend": "torch"} if mod is tfpm else {
            "backend": "pallas-interpret"}
        run = mod.MiningRun(arena, policy="clustered", n_workers=1,
                            granularity=granularity, cache_size=8,
                            item_counts=counts, **kw)
        try:
            mod.mine_more(run, ms, max_k, result, frequent, delta=plan)
        finally:
            run.close()
        met = run.finalize(0.0)
        out.append((plan.known, plan.reused, plan.swept_delta,
                    plan.swept_full, met.rows_touched, met.bytes_swept,
                    arena.h2d_bytes, result))
    assert out[0] == out[1]
    assert out[0][1] > 0 and out[0][2] > 0 and out[0][3] > 0
    want = rfpm.mine_serial(full, ms, max_k=max_k)
    got = {c: s for c, s in out[0][0].items() if s >= ms}
    got.update({c: s for c, s in out[0][7].items() if len(c) == 1})
    assert got == want


def test_bad_options_raise_value_error():
    bm = np.ones((3, 2), np.uint32)
    with pytest.raises(ValueError, match="granularity"):
        tfpm.mine(bm, 1, device="cpu", granularity="level")
    with pytest.raises(ValueError, match="representation"):
        tfpm.mine(bm, 1, device="cpu", representation="dense")
    with pytest.raises(ValueError, match="unknown join backend"):
        tfpm.mine(bm, 1, device="cpu", backend="pallas-jit")


# ----------------------------------------------------------- independence
def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            roots.update(a.value.split(".")[0] for a in node.args
                         if isinstance(a, ast.Constant)
                         and isinstance(a.value, str))
    return roots


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "_index_cases.py",
              *sorted((ROOT / "tools").glob("*.py")),
              *sorted((ROOT / "examples").glob("torch_*.py"))]
    assert len(files) > 10
    assert ROOT / "examples" / "torch_quickstart.py" in files
    for name in ("cluster.py", "distributed_fpm.py"):
        assert ROOT / "src" / "repro_torch" / "core" / name in files
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
