"""Each traffic mix through the harness for one short window on the CPU
(``device="cpu"``, a path only the tests take), its reductions, and the
command's refusals."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from perfbench import check, devtrace, harness, roofline, spec, workload
from perfbench.tests.conftest import ROOT


@pytest.mark.parametrize("cell", ["tiny.mine", "tiny.stream"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_a_correct_window_on_the_cpu(tiny_root, cell, trace):
    result, lines = harness.run(tiny_root, cell, 2**31 + 99, 0.5, trace,
                                device="cpu", log=lambda _: None)
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert all(v["value"] == 0 for v in result["checks"].values())
    assert lines == [f"check {k} 0 limit 0" for k in result["checks"]]
    kind = cell.split(".")[1]
    if trace:
        want = {"mine": {"flush_ms.mine", "occupancy.mine",
                         "blocked_share.mine", "h2d_mb.mine"},
                "stream": {"flush_ms.refresh", "reused_share.refresh",
                           "refresh_p95_s"}}[kind]
    else:
        want = {"setup_s", {"mine": "mine_s", "stream": "refresh_s"}[kind]}
    # device-trace metrics are not read on the CPU: left out, never 0
    assert set(result["metrics"]) == want
    assert all(m["value"] > 0 for k, m in result["metrics"].items()
               if k != "reused_share.refresh")


def test_stream_fails_when_its_pool_of_batches_is_spent(tiny_root):
    cell = spec.resolve(tiny_root, "tiny.stream")
    traffic = dict(cell.traffic, pool_batches=1)     # the warm-up takes it
    loop = workload.make(tiny_root, cell.config, traffic, 5, "cpu", False)
    try:
        with pytest.raises(RuntimeError, match="spent"):
            loop.window(0.2)
    finally:
        loop.release()


def test_cells_resolve_their_metrics_by_name():
    bench = spec.load_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = spec.resolve(ROOT, w["name"])
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.metric_reader(ROOT, m["name"]))
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_dense_and_sparse_bytes_count_each_row_and_sector_once():
    # two requests share prefix row 1 and extension row 7
    rows = [((1,), (5, 7), None), ((1,), (7, 9), None)]
    # rows {1, 5, 7, 9} at 10 words, lanes 1 + 2*2 per request
    assert roofline.dense_bytes(10, rows) == (4 * 10 + 10) * 4
    sparse = [((3,), (5, 7), np.array([0, 1, 300])),
              ((4,), (7,), np.array([2, 600]))]
    # sectors: row 5 {0, 1}, row 7 {0, 1} | {0, 2} = {0, 1, 2}
    sectors = 2 + 3
    words = (3 + 1 + 4) + (2 + 1 + 2)
    assert roofline.sparse_bytes(sparse) == sectors * 32 + words * 4


def test_device_union_gaps_and_busy_time():
    dt = devtrace.DeviceTrace(window=(0.0, 10.0), events=[
        ("k", 1.0, 2.0), ("copy", 1.5, 3.0), ("k", 5.0, 6.0),
        ("k", 9.5, 11.0)])
    assert devtrace.union([(1, 2), (1.5, 3), (5, 6)]) == [(1, 3), (5, 6)]
    assert dt.busy_s() == pytest.approx(2.0 + 1.0 + 0.5)
    assert dt.gaps() == [(6.0, 9.5), (3.0, 5.0), (0.0, 1.0)]
    assert dt.kernel_s("k") == pytest.approx(3.5)
    named = dt.idle_gaps(lambda t: f"at {t}", n=2)
    assert named == [["at 7.75", 3.5], ["at 4.0", 2.0]]
    namer = devtrace.activity_namer(
        [(0.0, 10.0)], [(0.0, 8.0, "driver", "level-3"),
                        (7.0, 7.5, "dispatcher-0", "flush")], "elsewhere")
    assert namer(7.2) == "dispatcher flush, host side"
    assert namer(6.0) == "level-3, dispatcher waiting on workers"
    assert namer(9.0) == "elsewhere"
    assert namer(11.0).startswith("harness, between")


def test_check_counts_missing_extra_and_miscounted_itemsets():
    want = {(1,): 5, (2,): 4, (1, 2): 3}
    assert check.itemsets_wrong(dict(want), want) == 0
    assert check.itemsets_wrong({(1,): 5, (2,): 4, (3,): 9}, want) == 2
    assert check.itemsets_wrong({(1,): 5, (2,): 4, (1, 2): 2}, want) == 1
    assert check.queries_wrong([1, 2, 3], [1, 2, 4]) == 1
    ok, lines, entry = check.verdict({"itemsets_wrong": 1})
    assert not ok and entry == {"itemsets_wrong": {"value": 1, "limit": 0}}


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["repro_torch.core.fpm", "numpy", "jaxlib.xla", "repro",
             "flaxen", "reproduce"]
    assert harness.forbidden_modules(names) == ["jaxlib", "repro"]


def _run_command(cwd):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "t10i4d100k.mine",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_command_without_a_card_exits_nonzero_with_no_result(card_absent):
    proc = _run_command(ROOT)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_command_without_the_program_exits_nonzero(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = _run_command(tmp_path)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


@pytest.mark.cuda
def test_cell_runs_correct_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "t10i4d100k.mine",
         "--seed", "5", "--seconds", "1", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
