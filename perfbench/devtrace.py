"""The device's side of a traced window, from ``torch.profiler``.

Only the card's activity is recorded (CUPTI kernels, copies and sets):
the program launches its kernels through ``ctypes``, which no host-side
operator record would see, and a host record of every operator would
slow the window it measures. Busy time is the UNION of the device
intervals inside the window, not their sum, since copies and kernels
of two streams may overlap. A marker kernel launched on an idle card at
a known host time maps the device clock onto the host's
``time.perf_counter``, so that an idle gap can be named by what the
host was doing.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

MARKER = "spin_kernel"          # the kernel of torch.cuda._sleep


def _kineto_events(prof) -> List[Tuple[str, float, float]]:
    """(name, start s, end s) of every device event, in the device's
    clock."""
    out = []
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        for ev in results.events():
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            if hasattr(ev, "start_ns"):
                t0, dur = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
            else:
                t0, dur = ev.start_us() * 1e-6, ev.duration_us() * 1e-6
            out.append((ev.name(), t0, t0 + dur))
        return out
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out.append((ev.name, ev.time_range.start * 1e-6,
                        ev.time_range.end * 1e-6))
    return out


def union(intervals: Sequence[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """Merged, sorted, disjoint cover of ``intervals``."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


@dataclass
class DeviceTrace:
    """Device events of one window, on the host's clock."""
    window: Tuple[float, float] = (0.0, 0.0)
    events: List[Tuple[str, float, float]] = field(default_factory=list)
    _prof: object = None
    _host_mark: float = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._host_mark = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def stop(self, window: Tuple[float, float]) -> None:
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        raw = _kineto_events(self._prof)
        self._prof = None
        marks = [t0 for name, t0, _ in raw if MARKER in name]
        if not marks:
            raise RuntimeError("the profiler recorded no marker kernel: "
                               "device activity was not traced")
        shift = min(marks) - self._host_mark
        self.window = window
        self.events = [(name, t0 - shift, t1 - shift)
                       for name, t0, t1 in raw if MARKER not in name]

    def clipped(self) -> List[Tuple[float, float]]:
        """Device intervals cut to the window."""
        w0, w1 = self.window
        return [(max(a, w0), min(b, w1)) for _, a, b in self.events
                if b > w0 and a < w1]

    def busy_s(self) -> float:
        return sum(b - a for a, b in union(self.clipped()))

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernel_s(self, name: str) -> float:
        """Device seconds of the kernels whose name holds ``name``."""
        return sum(t1 - t0 for n, t0, t1 in self.events if name in n)

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, t0, t1 in self.events:
            by[name] = by.get(name, 0.0) + (t1 - t0)
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle intervals of the window, longest first."""
        w0, w1 = self.window
        out, t = [], w0
        for a, b in union(self.clipped()):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if w1 > t:
            out.append((t, w1))
        return sorted(out, key=lambda g: g[0] - g[1])

    def idle_gaps(self, host_activity: Callable[[float], str],
                  n: int = 10) -> List[List]:
        """The ``n`` longest idle gaps, each named by what the host was
        doing at its midpoint."""
        return [[host_activity(0.5 * (a + b)), b - a]
                for a, b in self.gaps()[:n]]


def activity_namer(calls: Sequence[Tuple[float, float]],
                   spans: Sequence[Tuple[float, float, str, str]],
                   elsewhere: str) -> Callable[[float], str]:
    """Names a host moment: outside every timed call, inside a
    dispatcher flush or arena sync, inside a driver level, or elsewhere
    in a call (``elsewhere``). ``spans`` are (start, end, lane, name) on
    the host clock."""
    flushes = [(a, b, nm) for a, b, lane, nm in spans
               if lane.startswith("dispatcher") and nm in ("flush",
                                                           "h2d-sync")]
    levels = [(a, b, nm) for a, b, lane, nm in spans
              if lane == "driver" and nm.startswith("level-")]

    def name(t: float) -> str:
        if not any(a <= t <= b for a, b in calls):
            return "harness, between calls"
        inner: Optional[str] = None
        for a, b, nm in flushes:
            if a <= t <= b and (inner is None or nm == "h2d-sync"):
                inner = nm
        if inner is not None:
            return f"dispatcher {inner}, host side"
        for a, b, nm in levels:
            if a <= t <= b:
                return f"{nm}, dispatcher waiting on workers"
        return elsewhere
    return name
