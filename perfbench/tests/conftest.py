"""CPU tests of the benchmark: ``pytest perfbench/tests`` from the root
of the checkout. Tests that need the card are marked ``cuda`` and skip
here; the decision is made inside the ``card`` fixture."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a small deployment and stream for CPU windows: the loops and checks of
# the real cells at a size the CPU mines in about a second
TINY_CONFIG = {
    "name": "tiny", "n_transactions": 1500, "n_items": 120, "avg_len": 8,
    "avg_pattern": 4, "n_patterns": 40, "zipf": 0.9,
    "support": 0.02, "max_k": 4, "data_seed": 3,
    "engine": {"policy": "clustered", "n_workers": 4,
               "granularity": "bucket", "representation": "auto",
               "max_batch": 32, "arena": "auto"}}
TINY_STREAM = {"kind": "stream", "metric": "refresh_s", "batch": 100,
               "pool_batches": 60, "warmup": 1, "check_generations": 2,
               "queries": 30}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def card_absent():
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a card")


def make_root(tmp: Path) -> Path:
    """A copy of the benchmark with two tiny cells added as a later change
    would add them: new files and new entries, nothing edited."""
    root = tmp / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "perfbench" / "configs" / "tiny.json").write_text(
        json.dumps(TINY_CONFIG))
    (root / "perfbench" / "traffic" / "stream_tiny.json").write_text(
        json.dumps(TINY_STREAM))
    bench["configs"].append({
        "name": "tiny", "source": "a test deployment",
        "file": "perfbench/configs/tiny.json", "reduced": [],
        "why": "CPU tests"})
    bench["workloads"] += [
        {"name": "tiny.mine", "config": "tiny", "traffic": "mine",
         "chips": 1, "why": "CPU tests"},
        {"name": "tiny.stream", "config": "tiny", "traffic": "stream_tiny",
         "chips": 1, "why": "CPU tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kinds = {w.split(".")[-1] for w in m["workloads"]}
            m["workloads"] += [f"tiny.{k}" for k in ("mine", "stream")
                               if k in kinds]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("bench"))
