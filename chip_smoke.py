#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build    compile every CUDA kernel from ``src/repro_torch/kernels/
              csrc`` (one nvcc per source, in parallel) and print the
              card's name and power limit;
  2. parity   hold each kernel against its plain PyTorch version on the
              card at the main path's shapes and edge cases (exact: the
              counts are integers);
  3. main     batch bucket mining of T10I4D100K-size data (100,000
              transactions x 500 items, min support 0.5%) with
              ``representation="auto"``: supports must equal the host
              ``mine_serial`` and both kernels must have launched;
  4. bitmap   the same data with ``representation="bitmap"`` at
              max_k=4: only ``bitmap_join_many`` launches;
  5. profile  rerun phases 3 and 4 under torch.profiler for the device
              busy share and the top kernels by device time;
  6. report   time each kernel, its plain version and the gathered-copy
              step on inputs captured from phase 3, and print the
              kernels line and the final status line.

The script imports nothing of JAX or of the reference package ``repro``.
It exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import collections
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the 32-bit
# integer rate of the CUDA cores (half the 67 TFLOP/s fp32 rate).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
MAIN_MAX_K = 8
BITMAP_MAX_K = 4
SPIN_CYCLES = 200_000_000      # ~0.1 s of GPU spin ahead of a timing
L2_FLUSH_BYTES = 256 << 20     # > the H100's 50 MB L2


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3, cold: bool = False):
    """(device ms per call, host ms per call) of ``fn`` on the current
    stream. A GPU spin queued first keeps the card busy while the host
    enqueues the timed calls, so each event pair brackets device time
    only, and the wrappers' host cost (ctypes, checks, allocation) is
    timed apart. ``cold`` overwrites a buffer larger than the 50 MB L2
    before each call, so the call reads its inputs from HBM."""
    import torch
    for _ in range(warmup):
        fn()
    flush = (torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                         device="cuda") if cold else None)
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for start, end in pairs:
        if flush is not None:
            flush.fill_(0)
        start.record()
        fn()
        end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    if host_ms * iters > 0.5 * SPIN_CYCLES / 1.5e6:
        log(f"  warning: host enqueue ({host_ms * iters:.1f} ms) may "
            "outlast the GPU spin; device time may include idle")
    return sum(s.elapsed_time(e) for s, e in pairs) / iters, host_ms


def device_profile(fn, top: int = 6):
    """Run ``fn`` under torch.profiler; returns (wall s, device busy s,
    top kernels by device time). Device busy is the sum of the device
    time of every CUDA kernel and copy the profiler saw."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e6, ev.count, ev.key))
    rows.sort(reverse=True)
    return wall, sum(r[0] for r in rows), rows[:top]


# --------------------------------------------------------------- inputs --
def rand_words(rng, shape, dev):
    """Random uint32 words (about half with bit 31 set) as int32."""
    from repro_torch.core.tidlist import to_device_words
    return to_device_words(
        rng.integers(0, 2 ** 32, size=shape, dtype="uint32"), dev)


def rand_tids(rng, b, s, w, dev, empty_rows=()):
    """[b, s] sorted tids padded with -1: ragged rows, some all padding,
    bit positions 31 included."""
    import numpy as np
    import torch
    tids = np.full((b, s), -1, np.int32)
    for i in range(b):
        if i in empty_rows or s == 0:
            continue
        if i == 0:                       # every tid on a bit 31
            t = np.arange(min(s, w)) * 32 + 31
        else:
            n = int(rng.integers(1, min(s, 32 * w) + 1))
            t = np.sort(rng.choice(32 * w, size=n, replace=False))
        tids[i, :len(t)] = t
    return torch.from_numpy(tids).to(dev)


# ---------------------------------------------------------------- phases --
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {len(logs)} kernels compiled in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    return smi


def phase_parity(dev):
    """Exact kernel-vs-plain parity; returns the worst error per kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels.bitmap_join import ops as bj
    from repro_torch.kernels.bitmap_join.ref import bitmap_join_many_ref
    from repro_torch.kernels.gather_intersect import ops as gi
    from repro_torch.kernels.gather_intersect.ref import (
        gather_intersect_many_ref)
    rng = np.random.default_rng(0)
    worst = {"bitmap_join_many": 0, "gather_intersect_many": 0}

    def held(name, got, want, shape):
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) \
            if got.numel() else 0
        worst[name] = max(worst[name], err)
        ok = got.shape == want.shape and torch.equal(got, want)
        log(f"parity {name} {shape}: max_abs_err={err} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(f"{name} disagrees with its plain version "
                             f"at {shape}")

    # main-path shapes (B=32, E in {1, 64, 512}, W=4096), then edges:
    # W not a multiple of 4 (scalar loads), W past one shared-memory
    # chunk, a single word, all-ones words
    for b, e, w in [(32, 1, 4096), (32, 64, 4096), (32, 512, 4096),
                    (1, 1, 1), (3, 7, 33), (5, 70, 600), (2, 9, 12292),
                    (2, 9, 12301)]:
        p = rand_words(rng, (b, w), dev)
        x = rand_words(rng, (b, e, w), dev)
        held("bitmap_join_many", bj.bitmap_join_many(p, x),
             bitmap_join_many_ref(p, x), (b, e, w))
    ones = torch.full((2, 3, 40), -1, dtype=torch.int32, device=dev)
    held("bitmap_join_many", bj.bitmap_join_many(ones[:, 0].contiguous(),
                                                 ones),
         bitmap_join_many_ref(ones[:, 0], ones), "all-ones (2, 3, 40)")
    mask = torch.rand(32, 64, device=dev) < 0.5
    p = rand_words(rng, (32, 4096), dev)
    x = rand_words(rng, (32, 64, 4096), dev)
    held("bitmap_join_many", bj.bitmap_join_many(p, x, mask),
         torch.where(mask, bitmap_join_many_ref(p, x), 0), "masked")

    for b, e, s, w in [(32, 1, 64, 4096), (32, 64, 64, 4096),
                       (32, 512, 64, 4096), (32, 1, 8192, 4096),
                       (32, 64, 8192, 4096), (32, 512, 8192, 4096),
                       (8, 64, 1024, 4096), (3, 5, 9000, 400),
                       (4, 1, 64, 2)]:
        t = rand_tids(rng, b, s, w, dev, empty_rows=(1,))
        x = rand_words(rng, (b, e, w), dev)
        held("gather_intersect_many", gi.gather_intersect_many(t, x),
             gather_intersect_many_ref(t, x), (b, e, s, w))
    x = rand_words(rng, (32, 64, 4096), dev)
    empty = torch.zeros((32, 0), dtype=torch.int32, device=dev)
    n0 = gi.launches
    got = gi.gather_intersect_many(empty, x)
    if gi.launches != n0 or got.any():
        raise SystemExit("S=0 must be all-zero without a launch")
    log("parity gather_intersect_many (32, 64, 0, 4096): zeros, "
        "no launch ok")
    pad = torch.full((4, 64), -1, dtype=torch.int32, device=dev)
    held("gather_intersect_many", gi.gather_intersect_many(pad, x[:4]),
         gather_intersect_many_ref(pad, x[:4]), "all padding")
    return worst


class Recorder:
    """Wraps a kernel wrapper as the backend calls it: counts calls per
    input shape and keeps the first inputs of each shape for timing."""

    def __init__(self, fn):
        self.fn = fn
        self.shapes = collections.Counter()
        self.inputs = {}

    def __call__(self, a, b, mask=None):
        key = (tuple(a.shape), tuple(b.shape))
        self.shapes[key] += 1
        if key not in self.inputs:
            self.inputs[key] = (a.clone(), b.clone())
        return self.fn(a, b, mask)

    def main_shape(self):
        return self.shapes.most_common(1)[0][0]


def phase_mine(dev, bitmaps, counts, min_support, representation, max_k,
               serial, recorders=None):
    import repro_torch
    from repro_torch.core import join_backend
    from repro_torch.kernels.bitmap_join import ops as bj
    from repro_torch.kernels.gather_intersect import ops as gi
    if recorders is not None:
        join_backend.bitmap_join_many = recorders["bitmap_join_many"]
        join_backend.gather_intersect_many = recorders[
            "gather_intersect_many"]
    bj.launches = 0
    gi.launches = 0
    t0 = time.perf_counter()
    result, met = repro_torch.mine(
        bitmaps, min_support, device=dev, granularity="bucket",
        policy="clustered", max_k=max_k, representation=representation,
        item_counts=counts)
    wall = time.perf_counter() - t0
    launches = {"bitmap_join_many": bj.launches,
                "gather_intersect_many": gi.launches}
    if recorders is not None:
        join_backend.bitmap_join_many = recorders["bitmap_join_many"].fn
        join_backend.gather_intersect_many = recorders[
            "gather_intersect_many"].fn
    want = {c: s for c, s in serial.items() if len(c) <= max_k}
    if result != want:
        raise SystemExit(f"{representation}: supports differ from "
                         f"mine_serial ({len(result)} vs {len(want)})")
    log(f"mine[{representation}, max_k={max_k}]: wall_s={wall:.3f} "
        f"itemsets={len(result)} flushes={met.flushes} "
        f"occupancy={met.batch_occupancy:.2f} "
        f"dense_sweeps={met.dense_sweeps} sparse_sweeps={met.sparse_sweeps} "
        f"h2d_bytes={met.h2d_bytes} "
        f"sweep_s={met.per_device[0]['sweep_s']:.3f} "
        f"launches={json.dumps(launches)} supports==mine_serial ok")
    return launches, wall


def phase_profile(dev, bitmaps, counts, min_support, representation,
                  max_k):
    """A rerun of a mining phase under torch.profiler: how much of its
    wall time the device was busy, and on what."""
    import repro_torch

    def run():
        repro_torch.mine(bitmaps, min_support, device=dev,
                         granularity="bucket", policy="clustered",
                         max_k=max_k, representation=representation,
                         item_counts=counts)
    wall, busy, top = device_profile(run)
    log(f"profile mine[{representation}, max_k={max_k}] (profiled rerun): "
        f"wall_s={wall:.3f} device_busy_s={busy:.4f} "
        f"device_busy_share={busy / wall:.5f}")
    for sec, count, key in top:
        log(f"  device {sec:.4f} s in {count} x {key[:90]}")


def report(dev, recorders, launches, worst):
    """The kernels line: each kernel timed at its most frequent main-path
    shape, on inputs captured from that run."""
    import torch
    from repro_torch.kernels.bitmap_join import ops as bj
    from repro_torch.kernels.bitmap_join.ref import bitmap_join_many_ref
    from repro_torch.kernels.gather_intersect import ops as gi
    from repro_torch.kernels.gather_intersect.ref import (
        gather_intersect_many_ref)
    rows = []
    specs = [
        ("bitmap_join_many", bj.bitmap_join_many, bitmap_join_many_ref,
         "src/repro_torch/kernels/csrc/bitmap_join_many.cu",
         "src/repro/kernels/bitmap_join/kernel.py:116"),
        ("gather_intersect_many", gi.gather_intersect_many,
         gather_intersect_many_ref,
         "src/repro_torch/kernels/csrc/gather_intersect_many.cu",
         "src/repro/kernels/gather_intersect/kernel.py:74"),
    ]
    for name, kernel, plain, source, replaces in specs:
        rec = recorders[name]
        shape = rec.main_shape()
        a, x = rec.inputs[shape]
        got, want = kernel(a, x), plain(a, x)
        torch.cuda.synchronize()
        err = max(worst[name], int((got.long() - want.long()).abs().max()))
        if err:
            raise SystemExit(f"{name} disagrees on main-path inputs")
        # the backend hands the kernel exts it has just gathered, so the
        # main path reads them from L2: "ms" is that warm time, "ms_cold"
        # the time from HBM, the one the bytes bound speaks of
        ms, host_ms = time_ms(lambda: kernel(a, x))
        ms_cold, _ = time_ms(lambda: kernel(a, x), cold=True)
        plain_ms, _ = time_ms(lambda: plain(a, x), iters=3, warmup=1)
        b, e, w = x.shape
        if name == "bitmap_join_many":
            nbytes = (b * w + b * e * w + b * e) * 4
            ops = 3 * b * e * w
        else:
            # each valid tid reads one 32-byte sector of every extension
            # row in its batch row; a sector serves every tid inside it
            sectors = sum(int(torch.unique(r[r >= 0] >> 8).numel())
                          for r in a)
            valid = int((a >= 0).sum())
            nbytes = sectors * e * 32 + a.numel() * 4 + b * e * 4
            ops = 4 * valid * e
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "ms_cold": ms_cold, "host_ms": host_ms,
            "shape": [list(s) for s in shape],
            "main_path_calls_at_shape": rec.shapes[shape],
        })
        log(f"time {name} at {shape} ({rec.shapes[shape]} of "
            f"{sum(rec.shapes.values())} main-path calls): kernel {ms:.4f} "
            f"ms on the device, L2-warm ({ms_cold:.4f} ms from HBM; "
            f"{host_ms:.4f} ms host per launch), plain "
            f"{plain_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
            f"({rows[-1]['bound_by']}: {nbytes} B, {ops} ops)")
        log(f"  {name} shapes: {dict(rec.shapes.most_common(8))}")
        if name == "bitmap_join_many":
            # the backend's gathered [B, E, W] exts copy out of the mirror
            mirror = x.reshape(-1, w)
            idx = torch.randint(0, mirror.shape[0], (b * e,), device=dev)
            copy_ms, _ = time_ms(lambda: mirror.index_select(0, idx))
            log(f"time gathered exts copy [{b}, {e}, {w}] int32: "
                f"{copy_ms:.4f} ms")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.core import fpm
    from repro_torch.core.join_backend import (bitmap_join_many,
                                               gather_intersect_many)
    from repro_torch.core.tidlist import pack_database
    from repro_torch.data.transactions import load, min_support_count
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_build()
    worst = phase_parity(dev)

    t0 = time.perf_counter()
    db, prof = load("t10i4", scale=5)
    bitmaps, counts = pack_database(db, prof.n_items, return_counts=True)
    min_support = min_support_count(prof, db)
    log(f"data: t10i4 scale=5: {len(db)} transactions x {prof.n_items} "
        f"items, W={bitmaps.shape[1]}, min_support={min_support} "
        f"({time.perf_counter() - t0:.1f} s to generate and pack)")
    t0 = time.perf_counter()
    serial = fpm.mine_serial(bitmaps, min_support, max_k=MAIN_MAX_K)
    log(f"mine_serial max_k={MAIN_MAX_K}: {len(serial)} itemsets in "
        f"{time.perf_counter() - t0:.1f} s (host reference)")

    recorders = {"bitmap_join_many": Recorder(bitmap_join_many),
                 "gather_intersect_many": Recorder(gather_intersect_many)}
    launches, _ = phase_mine(dev, bitmaps, counts, min_support, "auto",
                             MAIN_MAX_K, serial, recorders)
    if min(launches.values()) == 0:
        raise SystemExit(f"a kernel never launched on the main path: "
                         f"{launches}")
    bitmap_launches, _ = phase_mine(dev, bitmaps, counts, min_support,
                                    "bitmap", BITMAP_MAX_K, serial)
    if (bitmap_launches["bitmap_join_many"] == 0
            or bitmap_launches["gather_intersect_many"] != 0):
        raise SystemExit(f"representation='bitmap' must launch only "
                         f"bitmap_join_many: {bitmap_launches}")

    phase_profile(dev, bitmaps, counts, min_support, "auto", MAIN_MAX_K)
    phase_profile(dev, bitmaps, counts, min_support, "bitmap",
                  BITMAP_MAX_K)
    rows = report(dev, recorders, launches, worst)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
