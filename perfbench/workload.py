"""What every traffic mix shares, and the lookup of a mix's loop by kind.

A mix is a data file, ``perfbench/traffic/<name>.json``. Its ``kind``
names the module that runs it, ``perfbench/traffic/<kind>.py``, found
by that name as a per-layer metric's reader is; its other keys are that
module's parameters. A kind module defines ``Loop(config, traffic,
seed, device, trace)``, whose ``window(seconds)`` returns the mix's
end-to-end metric, and ``control(config, traffic, seed, device)``, the
check's control at the cell's size (``perfbench/control.py``). A new
mix of a known kind adds a data file; a new kind adds a module too, and
edits nothing.

The configuration's ``data_seed`` draws its database; ``--seed`` draws
the order of its receipts (within the database, and within each of a
stream's batches), so that every seed does the same work. Set-up
(generation, packing, the program's objects, ``warmup`` calls of the
loop's own kind) is timed apart from the window. The window runs for
``seconds``, and the call that is running when it closes runs to its
end. A traced run attaches the program's tracer, wraps the kernel
backend's flush entry (``perfbench.roofline``) and records the card
(``perfbench.devtrace``); the per-layer metrics read those.
"""
from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench.data.quest import gen_quest

TRACER_RING = 1 << 20
CACHE = Path(__file__).resolve().parent / ".cache" / "data"
# the configuration's keys that gen_quest takes after the receipt count
QUEST_KEYS = ("n_items", "avg_len", "avg_pattern", "n_patterns", "zipf",
              "data_seed")


def receipts(config: Dict[str, Any], n: int) -> List[List[int]]:
    """The configuration's first ``n`` receipts: one database drawn from
    its ``data_seed``, the same in every run. Drawn once per checkout and
    kept under ``perfbench/.cache/data/`` (a few MB)."""
    key = json.dumps([config[k] for k in QUEST_KEYS] + [n])
    path = CACHE / (f"{config['name']}-"
                    f"{hashlib.sha1(key.encode()).hexdigest()[:16]}.npz")
    if path.exists():
        with np.load(path) as f:
            lengths, items = f["lengths"], f["items"]
        flat, ends = items.tolist(), np.cumsum(lengths).tolist()
        return [flat[a:b] for a, b in zip([0] + ends[:-1], ends)]
    db = gen_quest(n, *(config[k] for k in QUEST_KEYS))
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
    np.savez(tmp, lengths=np.array([len(t) for t in db], np.int32),
             items=np.array([i for t in db for i in t], np.int32))
    os.replace(tmp, path)
    return db


def shuffled(db: List[List[int]], seed: int,
             bounds: List[int]) -> List[List[int]]:
    """``db`` with the receipts of each block ``[bounds[j],
    bounds[j + 1])`` put in an order drawn from ``seed``: every seed
    mines the same receipts, so the same supports and the same work,
    laid out on other transaction ids."""
    rng = np.random.default_rng(seed)
    out: List[List[int]] = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        out.extend(db[int(i)] for i in rng.permutation(b - a) + a)
    return out


def engine_kwargs(config: Dict[str, Any]) -> Dict[str, Any]:
    e = config["engine"]
    return dict(policy=e["policy"], n_workers=e["n_workers"],
                granularity=e["granularity"],
                representation=e["representation"],
                max_batch=e["max_batch"], arena=e["arena"],
                max_k=config["max_k"])


@dataclass
class Readings:
    """What a run gathered, for the per-layer metrics to read."""
    window: Tuple[float, float] = (0.0, 0.0)   # host perf_counter
    calls: List[Tuple[float, float]] = field(default_factory=list)
    mine_metrics: list = field(default_factory=list)
    refresh_reports: list = field(default_factory=list)
    # (tracer, host time of its align instant, that instant's ts)
    tracers: list = field(default_factory=list)
    window_ts: Optional[float] = None     # stream: window-open instant ts
    device: Any = None                    # perfbench.devtrace.DeviceTrace
    requests: Any = None                  # perfbench.roofline.RequestLog
    device_name: str = ""

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def cycle_s(self) -> List[float]:
        return [b - a for a, b in self.calls]


def align(tracer, label: str) -> Tuple[float, float]:
    """(host perf_counter, tracer ts) of one instant, to map the tracer's
    timeline onto the host clock."""
    host = time.perf_counter()
    tracer.instant(label, cat="bench")
    ev = [e for e in tracer.events() if e.name == label][-1]
    return host, ev.ts


def kind_module(root: Path, kind: str):
    """``perfbench/traffic/<kind>.py`` under ``root``."""
    path = Path(root) / "perfbench" / "traffic" / f"{kind}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_traffic_" + kind.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make(root: Path, config, traffic, seed, device, trace):
    """The loop of ``traffic``'s kind, set up for one run."""
    return kind_module(root, traffic["kind"]).Loop(config, traffic, seed,
                                                   device, trace)


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
