"""The benchmark's definition, read from ``BENCHMARK.json`` by name.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found under the root of the checkout
by the name ``BENCHMARK.json`` gives it: each configuration's ``file``,
``perfbench/traffic/<traffic>.json`` (whose ``kind`` names the module
that runs it, ``perfbench/traffic/<kind>.py``) and
``perfbench/metrics/<metric>.py``. Adding a cell, a configuration, a
mix, a kind of mix or a metric adds files and entries and edits none.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional


@dataclass
class Cell:
    """One entry of ``workloads`` with what it names, resolved."""
    name: str
    root: Path
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_benchmark(root: Path) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: Dict[str, Any], cell: str,
             end_to_end: List[str]) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists, or, without the key, every cell that reports what it moves
    (a per-layer metric) or every cell (an end-to-end one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in end_to_end
    return True


def resolve(root: Path, name: str) -> Cell:
    """The cell ``name`` of the benchmark at ``root``."""
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; the benchmark has "
                         f"{sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "perfbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, [])]
    e2e_names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"]
             if _reports(m, name, e2e_names)]
    return Cell(name=name, root=root, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=layer)


def metric_reader(root: Path, name: str
                  ) -> Callable[[Any], Optional[float]]:
    """``read(readings)`` of ``perfbench/metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
