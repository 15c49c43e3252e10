"""One run of one cell: set-up, the window, the check, the result line.

``run`` returns the result object that ``perfbench/run.py`` prints as
its last line of standard output, and the lines that end standard
error: each number compared beside its limit.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from perfbench import check, spec, workload

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or ``names``) whose top-level name, compared
    whole, is JAX's or the JAX package's (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def host_ticks() -> Tuple[float, float]:
    """(this process's CPU seconds, the host's steal seconds) so far."""
    with open("/proc/stat") as f:
        cpu = f.readline().split()
    steal = int(cpu[8]) / os.sysconf("SC_CLK_TCK") if len(cpu) > 8 else 0.0
    t = os.times()
    return t.user + t.system, steal


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def host_spans(readings) -> List[Tuple[float, float, str, str]]:
    """Dispatcher and driver spans of the run's tracers on the host
    clock."""
    out = []
    for tracer, host, ts in readings.tracers:
        shift = host - ts
        for e in tracer.events():
            if e.ph == "X" and (e.lane == "driver"
                                or e.lane.startswith("dispatcher")):
                out.append((e.ts + shift, e.ts + e.dur + shift, e.lane,
                            e.name))
    return out


def run(root: Path, name: str, seed: int, seconds: float, trace: bool,
        device: "str | torch.device" = "cuda", log=print
        ) -> Tuple[Dict[str, Any], List[str]]:
    cell = spec.resolve(root, name)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    loop = workload.make(root, cell.config, cell.traffic, seed % (1 << 64),
                         dev, trace)
    log(f"set-up: {loop.setup_note}")
    rd = loop.readings
    requests = devtrace = None
    if trace:
        from perfbench.devtrace import DeviceTrace
        from perfbench.roofline import RequestLog
        requests = RequestLog().__enter__()
        if on_card:
            devtrace = DeviceTrace()
            devtrace.start()
    setup_s = process_age_s()
    cpu0, steal0 = host_ticks()
    try:
        e2e = loop.window(seconds)
        cpu1, steal1 = host_ticks()
    finally:
        if requests is not None:
            requests.__exit__()
    if devtrace is not None:
        devtrace.stop(rd.window)
    rd.device, rd.requests = devtrace, requests
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"the window loaded {bad}: the benchmark drives "
                         "the PyTorch port only")
    log(f"window: {len(rd.calls)} calls in {rd.window_s:.6f} s: "
        + " ".join(f"{b - a:.6f}" for a, b in rd.calls))
    log(f"window: process CPU {cpu1 - cpu0:.2f} s, host steal "
        f"{steal1 - steal0:.2f} s")
    log(loop.summary())
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    rd.device_name = kind
    metrics: Dict[str, Dict[str, Any]] = {}
    breakdown = None
    if not trace:
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = spec.metric_reader(root, m["name"])(rd)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if devtrace is not None:
            from perfbench.devtrace import activity_namer
            namer = activity_namer(rd.calls, host_spans(rd),
                                   loop.between_levels)
            breakdown = {"device_ops": devtrace.top_ops(),
                         "idle_gaps": devtrace.idle_gaps(namer)}
        dropped = sum(t.dropped() for t, _, _ in rd.tracers)
        if dropped:
            log(f"warning: the tracer dropped {dropped} events")
    attempted = loop.attempted()
    loop.release()
    workload.free_device()
    numbers, failed = loop.check()
    correct, lines, entry = check.verdict(numbers)
    device_info: Dict[str, Any] = {
        "platform": "gpu" if on_card else "cpu", "kind": kind,
        "count": cell.chips, "memory_peak_bytes": peak,
        "power_limit_w": power_limit_w() if on_card else None}
    if devtrace is not None:
        device_info["busy_s"] = devtrace.busy_s()
        device_info["window_s"] = devtrace.window_s()
    result: Dict[str, Any] = {
        "correct": correct, "attempted": attempted, "failed": failed,
        "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = entry
    return result, lines
