"""Reductions shared by the per-layer metric readers
(``perfbench/metrics/<metric>.py``). Each returns None where the run
recorded nothing to read, and the metric is then left out of the line.
"""
from __future__ import annotations

import math
from typing import List, Optional

from perfbench import roofline


def flush_ms(rd) -> Optional[float]:
    """Mean duration of the dispatcher's ``flush`` spans in the window."""
    durs: List[float] = []
    for tracer, _, _ in rd.tracers:
        for e in tracer.events():
            if (e.ph == "X" and e.name == "flush"
                    and (rd.window_ts is None or e.ts >= rd.window_ts)):
                durs.append(e.dur)
    return 1e3 * sum(durs) / len(durs) if durs else None


def blocked_share(rd) -> Optional[float]:
    """Workers' time blocked on the dispatcher (the ``sweep`` state) over
    their lanes' extent, in %."""
    from repro_torch.obs import time_in_state
    blocked = extent = 0.0
    for tracer, _, _ in rd.tracers:
        for row in time_in_state(tracer).values():
            if row["lane"].startswith("worker-"):
                blocked += row["sweep"]
                extent += row["extent"]
    return 100.0 * blocked / extent if extent else None


def occupancy(rd) -> Optional[float]:
    """Sweep requests per flush over every mine of the window."""
    flushes = sum(m.flushes for m in rd.mine_metrics)
    requests = sum(m.flushes * m.batch_occupancy for m in rd.mine_metrics)
    return requests / flushes if flushes else None


def h2d_mb(rd) -> Optional[float]:
    """Host-to-device bytes per mine, in MB."""
    mets = rd.mine_metrics
    return sum(m.h2d_bytes for m in mets) / len(mets) / 1e6 if mets else None


def reused_share(rd) -> Optional[float]:
    reps = rd.refresh_reports
    reused = sum(r.reused for r in reps)
    total = reused + sum(r.swept_delta + r.swept_full for r in reps)
    return 100.0 * reused / total if total else None


def p95(values: List[float]) -> Optional[float]:
    """Nearest-rank 95th percentile."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def idle_share(rd) -> Optional[float]:
    """Share of the window in which no kernel or copy ran, in %."""
    dev = rd.device
    if dev is None or dev.window_s() <= 0:
        return None
    return 100.0 * (1.0 - dev.busy_s() / dev.window_s())


def kernel_roofline(rd, kernel: str) -> Optional[float]:
    """Least time for the bytes the kernel's launches must move, at the
    card's HBM bandwidth, over the kernel's device time, in %."""
    dev, log = rd.device, rd.requests
    rate = roofline.hbm_bytes_per_s(rd.device_name)
    if dev is None or log is None or rate is None:
        return None
    device_s = dev.kernel_s(kernel)
    nbytes = log.bytes_by_kernel()[kernel]
    if device_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * (nbytes / rate) / device_s
