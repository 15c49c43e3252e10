"""The benchmark's imports, its definition's shape, and that a later change
can add a configuration, a cell and a metric as new files alone."""
from __future__ import annotations

import ast
import json
import re
from pathlib import Path

from perfbench import control, harness, spec, workload
from perfbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    for path in sorted((ROOT / "perfbench").rglob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "perfbench" / "reference").rglob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & (FORBIDDEN | {"repro_torch"}), path
    for path in [ROOT / "perfbench" / "check.py",
                 ROOT / "perfbench" / "data" / "quest.py"]:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "repro_torch" not in tops, path


def test_benchmark_definition_has_the_contract_shape():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"][1] == "perfbench/run.py"
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        config = json.loads((ROOT / c["file"]).read_text())
        for key in c["reduced"]:
            assert key in config and NAME.match(key)
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        traffic = ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json"
        kind = json.loads(traffic.read_text())["kind"]
        assert (ROOT / "perfbench" / "traffic" / f"{kind}.py").is_file()
        assert len(w["why"]) <= 200
        cells.add(w["name"])
    assert {c for w in bench["workloads"] for c in [w["config"]]} == set(
        configs)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", ())) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
    for w in cells:
        cell = spec.resolve(ROOT, w)
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)


NEW_KIND = """from pathlib import Path

from perfbench import workload

_mine = workload.kind_module(Path(__file__).resolve().parents[2], "mine")
control = _mine.control


class Loop(_mine.Loop):
    \"\"\"Mines with no warm-up call: a kind added as a file alone.\"\"\"

    def __init__(self, config, traffic, seed, device, trace):
        super().__init__(config, dict(traffic, warmup=0), seed, device,
                         trace)
"""


def test_a_later_change_adds_a_config_a_cell_and_a_metric_as_files(tiny_root):
    # make_root added the tiny configuration, a traffic mix and two
    # cells; add a new kind of mix, its cell and one more per-layer
    # metric the same way: new files and entries, nothing edited
    before = {p: p.read_bytes() for p in tiny_root.rglob("*")
              if p.is_file() and p.name != "BENCHMARK.json"}
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    (tiny_root / "perfbench" / "metrics" / "mines.mine.py").write_text(
        "def read(rd):\n    return float(len(rd.mine_metrics))\n")
    (tiny_root / "perfbench" / "traffic" / "cold.py").write_text(NEW_KIND)
    (tiny_root / "perfbench" / "traffic" / "cold_mine.json").write_text(
        json.dumps({"kind": "cold", "metric": "mine_s"}))
    bench["workloads"].append({"name": "tiny.cold", "config": "tiny",
                               "traffic": "cold_mine", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"]:
        if m["name"] == "mine_s":
            m["workloads"].append("tiny.cold")
    bench["per_layer"].append({
        "name": "mines.mine", "unit": "mines", "better": "higher",
        "source": "program_counter", "layer": "driver", "moves": "mine_s",
        "workloads": ["tiny.mine", "tiny.cold"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())
    cell = spec.resolve(tiny_root, "tiny.mine")
    assert cell.config["name"] == "tiny" and cell.traffic["kind"] == "mine"
    assert "mines.mine" in {m["name"] for m in cell.per_layer}
    assert spec.resolve(tiny_root, "tiny.stream").traffic["batch"] == 100
    result, _ = harness.run(tiny_root, "tiny.mine", 8, 0.3, True,
                            device="cpu", log=lambda _: None)
    assert result["metrics"]["mines.mine"]["value"] >= 1
    # the new kind runs, reports its metric, is checked and has a control
    result, _ = harness.run(tiny_root, "tiny.cold", 9, 0.3, False,
                            device="cpu", log=lambda _: None)
    assert result["correct"] and set(result["metrics"]) == {"setup_s",
                                                            "mine_s"}
    assert control.control_numbers(tiny_root, "tiny.cold", 9,
                                   device="cpu")["itemsets_wrong"] > 0
    # the real cells still resolve in the copy, each with its kind
    for w in spec.load_benchmark(ROOT)["workloads"]:
        cell = spec.resolve(tiny_root, w["name"])
        assert cell.name == w["name"]
        assert callable(workload.kind_module(tiny_root,
                                             cell.traffic["kind"]).Loop)
