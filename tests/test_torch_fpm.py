"""The slice end to end: the port's batch bucket mining against the
reference engine on the same inputs — supports and every deterministic
gauge — plus the device rule, the options a later slice covers, and the
rule that the port imports neither JAX nor the reference package."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro.core import fpm as rfpm
from repro_torch.core import fpm as tfpm
from repro_torch.core.tidlist import pack_database
from repro_torch.data import transactions as tt

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


@pytest.mark.parametrize("kwargs", [
    {"granularity": "depth-first"}, {"granularity": "auto"},
    {"mesh": 2}, {"hosts": 2}, {"trace": object()}])
def test_later_slices_raise_not_implemented(kwargs):
    with pytest.raises(NotImplementedError):
        tfpm.mine(np.ones((3, 2), np.uint32), 1, device="cpu", **kwargs)


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
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
