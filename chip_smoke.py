#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build    compile every CUDA kernel from ``src/repro_torch/kernels/
              csrc`` (one nvcc per source, in parallel) and print the
              card's name and power limit;
  2. parity   hold each kernel against its plain PyTorch version on the
              card at the main path's shapes and edge cases, the batched
              kernels through both their indexed entries (row store +
              indices, as the backend calls them) and their gathered
              forms (exact: the counts are integers); the dense kernel
              also with prefix tuples (pidx [B, L], L in {2, 3, 8}, mixed
              lengths and a pad request, segment-width stores of odd
              stride and of 79 words), each also against an explicit
              AND-then-join on the host;
  3. main     batch bucket mining of T10I4D100K-size data (100,000
              transactions x 500 items, min support 0.5%) at max_k=6
              (``MAIN_MAX_K``; see the end of this text) with
              ``representation="auto"``: supports must equal the host
              ``mine_serial`` and both batched kernels must have
              launched;
  4. bitmap   the same data with ``representation="bitmap"`` at
              max_k=4: only ``bitmap_join_many`` launches;
  5. depth-first  the phase-3 mine at ``granularity="depth-first"``:
              supports equal ``mine_serial``, ``bitmap_join_many``
              launched, and ``gather_intersect_many`` too when a class
              sweep was sparse;
  6. auto     the same at ``granularity="auto"``;
  7. entry    the single-prefix entry point ``repro_torch.kernels.
              bitmap_join.bitmap_join`` at the kernels-bench shape
              (E=4,096 x W=4,096) and at the T10I4D100K level-2 shape
              (one item row against all 500 at W=3,125), each held
              against its plain version and the host count;
  8. profile  rerun phases 3-6, and phase 13's two ingest+refresh
              rounds, under torch.profiler for the device busy share and
              the top kernels by device time;
  9. report   time each kernel and its plain version on inputs captured
              from phases 3, 5, 7, 13, 22 (chess) and 24 (retail); for
              the batched kernels also the
              parent design on the same inputs (a gathered [B, E, W]
              copy of mirror rows, then the gathered-form call) and the
              launch floor; print the kernels line and the status line.

Five more phases run after phase 7, before the profile, so that the
kernels line counts their launches:
 10. trace    the phase-3 mine again with a ``repro_torch.obs.Tracer``:
              supports equal ``mine_serial``, well-formed nesting, no
              dropped event, lanes ``driver``, ``dispatcher-0`` and 8
              workers, categories task/level/flush/sweep/arena; prints
              the traced wall beside phase 3's, each lane's time in
              state and the dispatcher's mean ``flush`` and ``h2d-sync``
              spans, and writes the Chrome trace to ``build/``;
 11. residency  the phase-3 mine at max_k=4 under ``arena="jax"``
              (eager upload: h2d after load equals the base payload)
              and ``arena="numpy"`` (no mirror: every sweep goes through
              the gathered forms, and never the indexed entries; max_k
              is raised until a sparse sweep launches
              ``gather_intersect_many`` too), each against
              ``mine_serial``, the gathered forms held against their
              plain versions on a captured call;
 12. launcher the launcher's ``main`` with the arguments of ``python -m
              repro_torch.launch.fpm_mine --dataset t10i4 --policies
              cilk clustered --max-k 6 --trace-summary`` (the paper's
              experiment: 20,000 transactions x 500 items at 0.5%
              support), in this process so that the launch counts are
              set to 0 just before it and read just after; it checks
              each policy against ``mine_serial`` itself, both batched
              kernels must have launched through their indexed entries,
              and each is held against its plain version on its first
              call's inputs;
 13. stream   ``StreamingMiner`` on the card over the first 90,000
              phase-3 transactions (bucket grain, clustered, 8 workers,
              ``arena="jax"``, ``representation="auto"``, max_k=6),
              refreshed, then the last 10,000 ingested in two batches,
              each followed by a refresh (compaction at each publish):
              each ingest bills exactly its segment's payload, the final
              supports equal ``mine_serial``, ``bitmap_join_many`` runs
              tuple prefixes and on more than one segment, and
              ``gather_intersect_many`` whenever a sweep was sparse;
              then serving on the final generation (``serve``): 256
              support hits, 256 ``top_k(prefix, 5)`` ranked on the card
              (each equal to the host ranking) and 256 ``support_many``
              batches of 8 never-counted itemsets (each equal to a host
              AND-popcount); prints the refresh walls, rows, reuse,
              compaction, flushes and occupancy, and the query p50/p99;
              the same stream at depth-first grain and max_k=4
              (``stream-depth-first``), which puts the depth-first delta
              path on the card;
 14. launcher-stream  the launcher's ``main`` with ``--dataset t10i4
              --stream 2 --serve 64 --max-k 6`` in this process; it
              checks the final generation against ``mine_serial``
              itself.
Four more phases follow, also before the profile, on the phase-3 data
(clustered, 8 workers per host):
 15. cluster  ``repro_torch.mine(hosts=2)`` at bucket grain and max_k=6
              (supports equal ``mine_serial``, one reduction per flush,
              ``net_bytes`` > 0, ``bitmap_join_many`` launched on both
              hosts' mirrors by their own flushes and by peer
              evaluations with tuple prefixes), then at max_k=4 three
              hosts, depth-first grain, and every bucket on host 0 (a
              cross-host steal must happen); prints wall, flushes,
              occupancy, ``net_bytes`` and each host's ``eval_s`` and
              ``eval_bytes`` beside phase 4;
 16. cluster-stream  ``StreamingMiner(hosts=2)`` on phase 13's stream at
              max_k=4 (``arena="jax"``): each ingest bills its segment's
              payload on the owner host and 0 B on the peer, and the
              final supports equal ``mine_serial``;
 17. tenants  a ``TenantHub`` with tenant a (weight 4, transactions
              0-49,999) and b (weight 1, 50,000-99,999), max_k=4: each
              mines 45,000, then ingests 2 x 2,500 with a refresh after
              each, the two tenants refreshing at once from two threads;
              during the second refresh 256 ``support_many`` batches of 8
              go to each tenant (each answer equal to a host
              AND-popcount over that tenant's data), and each final
              snapshot equals ``mine_serial`` of its own 50,000;
 18. hosts    the launcher's ``main`` with ``--dataset t10i4 --hosts 2
              --max-k 6``: two rank processes on the one card over a
              TCPStore; rank 0 checks its result against ``mine_serial``,
              each rank prints its kernel launches (parsed here; both
              must be > 0), and a rank's non-zero exit fails the phase.
Three more phases follow, also before the profile, on two logical
shards of the one card (two mirrors, two dispatchers, two backends):
 19. mesh     ``repro_torch.mine(mesh=2)`` on the phase-3 data at bucket
              grain and max_k=6 (supports equal ``mine_serial``, two
              devices, both dispatchers flushed, both batched kernels
              launched on each shard's mirror, ``d2d_bytes`` a whole
              number of rows), then at max_k=4 candidate grain (every
              join through a shard's dispatcher), depth-first grain,
              every root class on shard 0's workers (cross-shard steals
              must migrate rows: ``migrations``, ``d2d_bytes`` and
              ``steal_migrations`` > 0; of up to three attempts only the
              kept one is counted), a one-device mesh ``[cuda:0]`` at
              phase 4's settings (no d2d) and
              ``repro_torch.mine_distributed(mesh=2)`` under both
              policies; each run's wall beside phase 3's (or phase
              4's at max_k=4), with per-shard flushes, occupancy,
              ``sweep_s``, ``d2d_bytes`` and ``migrations``;
 20. mesh-stream  ``StreamingMiner(mesh=2)`` on phase 13's stream at
              max_k=4 (``arena="jax"``): each ingest bills its segment
              once per shard, the final supports equal ``mine_serial``,
              tuple-prefix launches on both shards' mirrors, and 64
              ``support_many`` batches of 8 answered through priority
              sweeps on both shards' dispatchers (each equal to a host
              AND-popcount); then ``TenantHub(mesh=2)`` with phase 17's
              two tenants, each final snapshot equal to ``mine_serial``
              of its own data;
 21. launcher-mesh  the launcher's ``main`` with ``--dataset t10i4 --mesh
              2 --policies clustered --max-k 6`` in this process; it
              checks ``mine_serial`` itself and prints ``d2d=``,
              ``migrations=`` and ``dev_occ=``.
Three more phases follow, also before the profile: the ``run`` function
of each example script (``examples/torch_*.py``), called in this
process, each mine or refresh in it timed and counted alone
(``CallSpy``):
 22. quickstart  ``torch_quickstart.run`` on the chess profile (3,196
              transactions x 75 items, W=100, support 60%) at max_k=3:
              Cilk and clustered at candidate grain (host joins: no
              launch), then candidate, bucket and depth-first grain,
              each equal to ``mine_serial``; prints each run's cache hit
              rate and tasks per steal; the bucket mine's launches are
              recorded for a phase-9 row at the chess shape;
 23. distributed  ``torch_distributed_mining.run``: mushroom cut to
              2,500 transactions over eight logical shards of the one
              card, ``mine(mesh=)`` at bucket and depth-first grain and
              ``mine_distributed`` under round_robin and clustered (max_k
              =4), each equal to ``mine_serial``; ``bitmap_join_many``
              must launch on all eight shards' mirrors;
 24. streaming-patterns  ``torch_streaming_patterns.run``: retail (1,200
              items, Zipf 1.05), the first 10,000 transactions mined,
              then four ingests of 500, each followed by a top-3 query
              and a refresh (max_k=5, 4 workers) under the fraction
              threshold 1.2%, which rises with the data, so itemsets die
              and return: every generation equal to ``mine_serial`` at
              its own threshold, some generation with deaths, tuple-
              prefix launches from the delta refreshes, ``support()`` of
              the top itemset equal to a host count; the initial
              refresh's launches are recorded for a phase-9
              ``gather_intersect_many`` row at the retail shape.
Each run of phases 11-24 wraps the backend's four kernel entries
(``EntrySpy``): calls must equal the counted launches, and each entry's
first call (and the dense entry's first tuple-prefix call) is held
against its plain version; in phases 15-16 also the first tuple-prefix
call of a peer evaluation (``HostSpy``), and in phases 19-21 and 23 the
first call on each shard's mirror (``ShardSpy``, which attributes every
launch to the shard whose mirror it was handed).

Depth, cut to fit the time limit: every phase that mines the t10i4 data
at the main depth (3, 5, 6, 10, 12-15, 18, 19, 21 and the profile) runs
at max_k=6 (``MAIN_MAX_K``), not 8. At 8 the whole smoke took 1,442.7 s
of its 1,200 s on an H100 whose host ran phase 3 in 48.7 s (37.6 s on
another call); levels 7 and 8 carry about half of those mines' work. A
``clock:`` line after each phase gives its wall and the running total.
No path stops being driven and no kernel loses a parity check.

The script imports nothing of JAX or of the reference package ``repro``.
It exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import collections
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests"), str(ROOT / "examples")]

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the 32-bit
# integer rate of the CUDA cores (half the 67 TFLOP/s fp32 rate).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
MAIN_MAX_K = 6                 # T10I4's levels run to 8; see the docstring
BITMAP_MAX_K = 4
BENCH_E, BENCH_W = 4096, 4096  # benchmarks/kernels_bench.py's join shape
SPIN_CYCLES = 200_000_000      # ~0.1 s of GPU spin ahead of a timing
L2_FLUSH_BYTES = 256 << 20     # > the H100's 50 MB L2


def log(msg: str) -> None:
    # one write per line: phase 17 logs from two threads at once
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


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


def device_profile(fn, top: int = 10):
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

    import _index_cases as cases
    from repro_torch.core.tidlist import to_device_words
    from repro_torch.kernels.bitmap_join import ops as bj
    from repro_torch.kernels.bitmap_join.ref import (
        bitmap_join_many_ref, bitmap_join_many_rows_ref, bitmap_join_ref)
    from repro_torch.kernels.gather_intersect import ops as gi
    from repro_torch.kernels.gather_intersect.ref import (
        gather_intersect_many_ref, gather_intersect_many_rows_ref)
    rng = np.random.default_rng(0)
    worst = {"bitmap_join_many": 0, "gather_intersect_many": 0,
             "bitmap_join": 0}

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

    # the indexed entries as the backend calls them, on a row store:
    # repeated handles, pad requests and lanes (-1), lens shorter than
    # S, n_words below the stride, rows off the 16-byte grid, the
    # phase-3 and phase-5 shapes over the mirror's pow2 stride, S above
    # one tid tile, W past one shared-memory chunk, the grid's edges
    def dev_int(a):
        return torch.from_numpy(a).to(dev)

    for n_rows, stride, n_words, b, e in [
            (6, 8, 8, 3, 5), (20, 64, 33, 4, 9), (9, 3125, 3125, 2, 3),
            (300, 4096, 3125, 8, 256), (300, 4096, 3125, 1, 256),
            (40, 3125, 3125, 5, 257), (7, 4, 1, 65535, 1),
            (7, 4, 3, 1, 8 * 65535), (3, 40000, 40000, 1, 2)]:
        m, pidx, eidx = cases.dense_case(rng, n_rows, stride, b, e)
        store = to_device_words(m, dev)
        args = (store, dev_int(pidx), store, dev_int(eidx), n_words)
        held("bitmap_join_many", bj.bitmap_join_many_rows(*args),
             bitmap_join_many_rows_ref(*args),
             f"indexed store [{n_rows}, {stride}] n_words={n_words} "
             f"B={b} E={e}")
    # tuple prefixes pidx [B, L] (the streaming path's delta and query
    # sweeps): L in {2, 3, 8}, mixed tuple lengths in one batch and a
    # pad request in every case, segment-width stores of odd stride and
    # of 79 words, phase-13 shapes (up to 32 requests over a pow2
    # segment stride), each also held against an explicit AND-then-join
    # on the host
    from repro_torch.core.tidlist import popcount32
    for n_rows, stride, n_words, b, e, tuple_len in [
            (6, 8, 8, 3, 5, 2), (20, 64, 33, 4, 9, 3), (30, 79, 79, 5, 7, 8),
            (16, 333, 333, 4, 70, 3), (600, 256, 157, 32, 64, 3),
            (600, 256, 157, 32, 1, 8), (600, 4096, 2970, 8, 1, 8),
            (600, 4096, 3125, 4, 257, 2)]:
        m, pidx, eidx = cases.tuple_case(rng, n_rows, stride, b, e,
                                         tuple_len)
        store = to_device_words(m, dev)
        args = (store, dev_int(pidx), store, dev_int(eidx), n_words)
        got = bj.bitmap_join_many_rows(*args)
        shape = (f"tuple prefixes L={tuple_len} store [{n_rows}, {stride}] "
                 f"n_words={n_words} B={b} E={e}")
        held("bitmap_join_many", got, bitmap_join_many_rows_ref(*args),
             shape)
        host = popcount32(cases.gathered_tuple_prefixes(m, pidx, n_words)
                          [:, None, :]
                          & cases.gathered_rows(m, eidx, n_words)).sum(2)
        if not np.array_equal(got.cpu().numpy(), host):
            raise SystemExit(f"bitmap_join_many disagrees with the host "
                             f"AND-then-join at {shape}")
    for n_rows, stride, n_words, b, e, s, past in [
            (6, 8, 8, 3, 5, 40, False), (20, 64, 33, 4, 9, 70, True),
            (9, 3125, 3125, 3, 3, 300, False),
            (300, 4096, 3125, 4, 64, 1024, False),
            (300, 4096, 3125, 1, 256, 2000, False),
            (40, 4096, 3125, 8, 65, 8192, False),
            (7, 4, 1, 65535, 1, 2, False), (7, 4, 3, 2, 8 * 65535, 3, False)]:
        m, tids, lens, eidx = cases.sparse_case(rng, n_rows, stride, n_words,
                                                b, e, s, past_width=past)
        args = (dev_int(tids), dev_int(lens), to_device_words(m, dev),
                dev_int(eidx), n_words)
        held("gather_intersect_many", gi.gather_intersect_many_rows(*args),
             gather_intersect_many_rows_ref(*args),
             f"indexed store [{n_rows}, {stride}] n_words={n_words} B={b} "
             f"E={e} S={s}{' tids past n_words' if past else ''}")

    # the entry point's shapes (kernels bench; T10I4D100K level 2, rows
    # off the 16-byte grid), then edges: E=1, W % 4 != 0, W past one
    # shared-memory chunk, a tensor whose base is off the 16-byte grid,
    # all-ones words
    for e, w in [(BENCH_E, BENCH_W), (500, 3125), (1, 1), (1, 3), (7, 33),
                 (513, 1025), (3, 12289), (9, 12301)]:
        p = rand_words(rng, (w,), dev)
        x = rand_words(rng, (e, w), dev)
        held("bitmap_join", bj.bitmap_join(p, x), bitmap_join_ref(p, x),
             (e, w))
    x = rand_words(rng, (9, 37), dev)[1:]
    p = rand_words(rng, (37,), dev)
    held("bitmap_join", bj.bitmap_join(p, x), bitmap_join_ref(p, x),
         "offset base (8, 37)")
    ones = torch.full((5, 40), -1, dtype=torch.int32, device=dev)
    held("bitmap_join", bj.bitmap_join(ones[0], ones),
         bitmap_join_ref(ones[0], ones), "all-ones (5, 40)")
    return worst


class Recorder:
    """Wraps an indexed kernel entry as the backend calls it: counts the
    calls per batch shape (the reference's padded B', [S',] E'), keeps
    the index arguments of the first call of each shape, and one clone
    of the arena mirror, taken by :meth:`freeze` after the phase (the
    mirror only grows, so it holds every row a kept index names)."""

    def __init__(self, fn, sparse):
        self.fn = fn
        self.sparse = sparse
        # positions of the index arguments; position 2 is the mirror
        # (and, dense, position 0 too)
        self.index_args = (0, 1, 3) if sparse else (1, 3)
        self.shapes = collections.Counter()
        self.inputs = {}
        self.mirror = None

    def key(self, args):
        from repro_torch.core.tidlist import pow2
        b, e = args[3].shape
        if self.sparse:
            return pow2(b), pow2(args[0].shape[1], lo=64), pow2(e, lo=64)
        return pow2(b), pow2(e, lo=64)

    def __call__(self, *args):
        key = self.key(args)
        self.shapes[key] += 1
        if key not in self.inputs:
            self.inputs[key] = {i: args[i].clone() for i in self.index_args}
            self.inputs[key][4] = args[4]
        self.mirror = args[2]
        return self.fn(*args)

    def freeze(self):
        if self.mirror is not None:
            self.mirror = self.mirror.clone()

    def main_shape(self):
        return self.shapes.most_common(1)[0][0]

    def case(self, key):
        """The entry's arguments of the first call at ``key``, on the
        mirror's clone."""
        kept = self.inputs[key]
        return tuple(kept.get(i, self.mirror) for i in range(5))


def phase_mine(dev, bitmaps, counts, min_support, granularity,
               representation, max_k, serial, recorders=None):
    """One mine through ``repro_torch.mine`` with the launch counts set
    to 0 just before it; returns (launches per kernel, metrics)."""
    import repro_torch
    from repro_torch.core import join_backend
    from repro_torch.kernels.bitmap_join import ops as bj
    from repro_torch.kernels.gather_intersect import ops as gi
    if recorders is not None:
        join_backend.bitmap_join_many_rows = recorders["bitmap_join_many"]
        join_backend.gather_intersect_many_rows = recorders[
            "gather_intersect_many"]
    bj.launches = 0
    gi.launches = 0
    t0 = time.perf_counter()
    result, met = repro_torch.mine(
        bitmaps, min_support, device=dev, granularity=granularity,
        policy="clustered", max_k=max_k, representation=representation,
        item_counts=counts)
    wall = time.perf_counter() - t0
    launches = {"bitmap_join_many": bj.launches,
                "gather_intersect_many": gi.launches}
    if recorders is not None:
        for name, rec in recorders.items():
            setattr(join_backend, f"{name}_rows", rec.fn)
            rec.freeze()
    label = f"{granularity}, {representation}, max_k={max_k}"
    want = {c: s for c, s in serial.items() if len(c) <= max_k}
    if result != want:
        raise SystemExit(f"mine[{label}]: supports differ from "
                         f"mine_serial ({len(result)} vs {len(want)})")
    log(f"mine[{label}]: wall_s={wall:.3f} "
        f"itemsets={len(result)} flushes={met.flushes} "
        f"occupancy={met.batch_occupancy:.2f} "
        f"dense_sweeps={met.dense_sweeps} sparse_sweeps={met.sparse_sweeps} "
        f"class_or_bucket_tasks={met.buckets} "
        f"peak_retained_bitmaps={met.peak_retained_bitmaps} "
        f"h2d_bytes={met.h2d_bytes} "
        f"sweep_s={met.per_device[0]['sweep_s']:.3f} "
        f"launches={json.dumps(launches)} supports==mine_serial ok")
    return launches, met


def phase_entry(dev, bitmaps, counts):
    """The single-prefix entry point on the card, with its launch count
    set to 0 just before and read just after: the kernels-bench shape
    and the T10I4D100K level-2 shape (the most frequent item's row
    against every item row). Returns (launches, {shape label: inputs})."""
    import numpy as np
    import torch
    from repro_torch.core.tidlist import support_counts, to_device_words
    from repro_torch.kernels import bitmap_join as entry
    from repro_torch.kernels.bitmap_join import ops as bj
    from repro_torch.kernels.bitmap_join.ref import bitmap_join_ref
    rng = np.random.default_rng(1)
    top = int(np.argmax(counts))
    inputs = {
        "kernels-bench": (rand_words(rng, (BENCH_W,), dev),
                          rand_words(rng, (BENCH_E, BENCH_W), dev)),
        "t10i4 level 2": (to_device_words(bitmaps[top], dev),
                          to_device_words(bitmaps, dev)),
    }
    bj.single_launches = 0
    got = {k: entry.bitmap_join(p, x) for k, (p, x) in inputs.items()}
    torch.cuda.synchronize()
    launches = bj.single_launches
    for k, (p, x) in inputs.items():
        want = bitmap_join_ref(p, x)
        if not torch.equal(got[k], want):
            raise SystemExit(f"bitmap_join disagrees with its plain "
                             f"version at {k} {tuple(x.shape)}")
        log(f"entry bitmap_join[{k}] {tuple(x.shape)}: equals its plain "
            f"version ok")
    host = support_counts(bitmaps[top], bitmaps)
    if not np.array_equal(got["t10i4 level 2"].cpu().numpy(), host):
        raise SystemExit("bitmap_join disagrees with the host count at "
                         "the level-2 shape")
    log(f"entry bitmap_join: level-2 counts equal the host's "
        f"support_counts (item {top}) ok; launches={launches}")
    if launches != len(inputs):
        raise SystemExit(f"the entry point launched bitmap_join "
                         f"{launches} times for {len(inputs)} calls")
    return launches, inputs


def phase_trace(dev, bitmaps, counts, min_support, serial, untraced_wall):
    """The phase-3 mine with a tracer attached; returns its launches."""
    import repro_torch
    from repro_torch.kernels.bitmap_join import ops as bj
    from repro_torch.kernels.gather_intersect import ops as gi
    from repro_torch.obs import (Tracer, check_nesting, time_in_state,
                                 write_chrome_trace)
    tr = Tracer()
    bj.launches = 0
    gi.launches = 0
    result, met = repro_torch.mine(
        bitmaps, min_support, device=dev, granularity="bucket",
        policy="clustered", max_k=MAIN_MAX_K, representation="auto",
        item_counts=counts, trace=tr)
    launches = {"bitmap_join_many": bj.launches,
                "gather_intersect_many": gi.launches}
    if result != serial:
        raise SystemExit("trace: supports differ from mine_serial")
    events = tr.events()
    bad = check_nesting(events)
    if bad:
        raise SystemExit(f"trace: {len(bad)} spans straddle, e.g. {bad[0]}")
    if tr.dropped():
        raise SystemExit(f"trace: {tr.dropped()} events dropped at the "
                         f"default ring size {tr.ring_size}")
    lanes = tr.lane_names()
    workers = [n for n in lanes if n.startswith("worker-")]
    if not {"driver", "dispatcher-0"} <= set(lanes) or len(workers) != 8:
        raise SystemExit(f"trace: lanes {lanes}")
    cats = {e.cat for e in events}
    need = {"task", "level", "flush", "sweep", "arena"}
    if not need <= cats:
        raise SystemExit(f"trace: categories {sorted(cats)} lack "
                         f"{sorted(need - cats)}")
    path = ROOT / "build" / "trace_phase3.json"
    path.parent.mkdir(exist_ok=True)
    write_chrome_trace(tr, str(path))
    log(f"trace mine[bucket, auto, max_k={MAIN_MAX_K}]: traced wall_s="
        f"{met.wall_s:.3f} against phase 3's untraced {untraced_wall:.3f} "
        f"({met.wall_s - untraced_wall:+.3f} s; MiningMetrics.wall_s of "
        f"both); flushes={met.flushes} "
        f"events={len(events)} dropped=0 lanes={len(lanes)} "
        f"launches={json.dumps(launches)} supports==mine_serial ok; "
        f"wrote {path.relative_to(ROOT)}")
    states = ("eval", "sweep", "idle", "steal", "other")
    shares = {s: 0.0 for s in states}
    extent = 0.0
    for row in time_in_state(tr).values():
        ext = row["extent"] or 1.0
        log(f"  time in state [{row['lane']}]: extent {row['extent']:.3f} s"
            f", " + ", ".join(f"{s} {row[s] / ext:.4f}" for s in states)
            + f", untraced {1 - row['total'] / ext:.4f}")
        if row["lane"].startswith("worker-"):
            extent += row["extent"]
            for s in states:
                shares[s] += row[s]
    log("  workers together: " + ", ".join(
        f"{s} {shares[s] / extent:.4f}" for s in states)
        + " (eval = task self time, sweep = blocked on the dispatcher, "
        "idle = parked)")
    disp = [e for e in events if e.lane == "dispatcher-0" and e.ph == "X"]
    flush = [e.dur for e in disp if e.name == "flush"]
    sync = [e.dur for e in disp if e.name == "h2d-sync"]
    span = max(e.ts + e.dur for e in disp) - min(e.ts for e in disp)
    log(f"  dispatcher-0: {len(flush)} flush spans, mean "
        f"{1e3 * sum(flush) / len(flush):.4f} ms, "
        f"{sum(flush) / span:.4f} of the lane's extent {span:.3f} s; "
        f"{len(sync)} h2d-sync spans, mean "
        f"{1e3 * sum(sync) / max(1, len(sync)):.4f} ms, "
        f"{sum(sync) / sum(flush):.4f} of flush time; "
        f"sync per flush {1e3 * sum(sync) / len(flush):.4f} ms")
    return launches


class EntrySpy:
    """Wraps the backend's four kernel entries for one run: counts each
    entry's calls and keeps a clone of its first call's arguments (and of
    the dense entry's first tuple-prefix call), so that each kernel can
    be held against its plain version at the run's own shapes after it
    (the counters of the wrappers are read before that, so the
    comparison's launches are not counted). For the dense indexed entry
    it also counts the calls per segment width and, for tuple prefixes
    (pidx [B, L]), per padded shape (B', L, E', W_seg), keeping the
    first call's arguments at up to ``KEEP`` such shapes."""

    GATHERED = ("bitmap_join_many", "gather_intersect_many")
    INDEXED = ("bitmap_join_many_rows", "gather_intersect_many_rows")
    KEEP = 32

    def __enter__(self):
        from repro_torch.core import join_backend
        self.calls, self.kept = collections.Counter(), {}
        self.widths = collections.Counter()     # dense calls per W_seg
        self.tuple_shapes = collections.Counter()
        self.tuple_inputs = {}
        self.originals = {n: getattr(join_backend, n)
                          for n in self.GATHERED + self.INDEXED}
        for name in self.originals:
            setattr(join_backend, name, self._wrap(name))
        return self

    def _clone(self, args):
        import torch
        return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                     for a in args)

    def _wrap(self, name):
        from repro_torch.core.tidlist import pow2
        fn = self.originals[name]

        def call(*args):
            self.calls[name] += 1
            if name not in self.kept:
                self.kept[name] = self._clone(args)
            if name == "bitmap_join_many_rows":
                self.widths[args[4]] += 1
                if args[1].dim() == 2:
                    b, e = args[3].shape
                    key = (pow2(b), args[1].shape[1], pow2(e, lo=64),
                           args[4])
                    self.tuple_shapes[key] += 1
                    if (key not in self.tuple_inputs
                            and len(self.tuple_inputs) < self.KEEP):
                        # the mirror is both stores: clone it once
                        kept = self._clone(args[1:2] + args[3:])
                        store = args[2].clone()
                        self.tuple_inputs[key] = (store, kept[0], store,
                                                  kept[1], kept[2])
                    if (name + ":tuple" not in self.kept
                            and self.kept[name][1].dim() == 1):
                        self.kept[name + ":tuple"] = self._clone(args)
            return fn(*args)
        return call

    def __exit__(self, *exc):
        from repro_torch.core import join_backend
        for name, fn in self.originals.items():
            setattr(join_backend, name, fn)

    def check_route(self, label, launches, sparse_sweeps, indexed):
        """Every launch went through the indexed entries (or, with
        ``indexed`` false, the gathered forms) and none through the
        other; ``bitmap_join_many`` launched, and ``gather_intersect_
        many`` too when a sweep was sparse."""
        used = self.INDEXED if indexed else self.GATHERED
        other = self.GATHERED if indexed else self.INDEXED
        got = tuple(self.calls[n] for n in used)
        if (any(self.calls[n] for n in other) or got[0] == 0
                or (sparse_sweeps and got[1] == 0)
                or got != tuple(launches.values())):
            raise SystemExit(f"{label}: entry calls {dict(self.calls)} "
                             f"against launches {launches}")

    def hold(self, label):
        """Each kept call against its plain version on the same inputs."""
        import torch
        from repro_torch.kernels.bitmap_join import ops as bj
        from repro_torch.kernels.bitmap_join import ref as bj_ref
        from repro_torch.kernels.gather_intersect import ops as gi
        from repro_torch.kernels.gather_intersect import ref as gi_ref
        for label_name, args in self.kept.items():
            name = label_name.split(":")[0]
            ops, ref = (bj, bj_ref) if name.startswith("bitmap") else (
                gi, gi_ref)
            got = getattr(ops, name)(*args)
            want = getattr(ref, f"{name}_ref")(*args)
            torch.cuda.synchronize()
            shape = (describe(name[:-len("_rows")], args)
                     if name in self.INDEXED
                     else [tuple(a.shape) for a in args])
            if not torch.equal(got, want):
                raise SystemExit(f"{label}: {name} disagrees with its "
                                 f"plain version at {shape}")
            log(f"  {label}: {name} at its first call of the run "
                f"({shape}): equals its plain version ok")


def counted_launches():
    from repro_torch.kernels.bitmap_join import ops as bj
    from repro_torch.kernels.gather_intersect import ops as gi
    return {"bitmap_join_many": bj.launches,
            "gather_intersect_many": gi.launches}


def reset_launches():
    from repro_torch.kernels.bitmap_join import ops as bj
    from repro_torch.kernels.gather_intersect import ops as gi
    bj.launches = 0
    gi.launches = 0


def phase_residency(dev, bitmaps, counts, min_support, serial):
    """The phase-3 mine under ``arena="jax"`` and ``arena="numpy"``;
    returns the launches of each run."""
    import repro_torch
    from repro_torch.core.tidlist import BitmapArena
    eager = BitmapArena.from_bitmaps(bitmaps, device=dev, backing="jax")
    if eager.h2d_bytes != eager.nbytes_base:
        raise SystemExit(f"residency: arena='jax' uploaded "
                         f"{eager.h2d_bytes} B at load, not the base "
                         f"payload {eager.nbytes_base} B")
    log(f"residency: arena='jax' uploads the base payload at load: "
        f"h2d_bytes={eager.h2d_bytes} == {eager.nbytes_base} ok")
    del eager

    def run(backing, max_k):
        """One mine with the backend's kernel entries spied on."""
        with EntrySpy() as spy:
            reset_launches()
            t0 = time.perf_counter()
            result, met = repro_torch.mine(
                bitmaps, min_support, device=dev, granularity="bucket",
                policy="clustered", max_k=max_k, representation="auto",
                item_counts=counts, arena=backing)
            wall = time.perf_counter() - t0
            launches = counted_launches()
        return result, met, wall, launches, spy

    out = {}
    for backing in ("jax", "numpy"):
        max_k = BITMAP_MAX_K
        while True:
            result, met, wall, launches, spy = run(backing, max_k)
            if (backing == "jax" or launches["gather_intersect_many"]
                    or max_k == MAIN_MAX_K):
                break
            log(f"residency[numpy]: max_k={max_k} launched no "
                f"gather_intersect_many; raising max_k")
            max_k += 1
        want = {c: v for c, v in serial.items() if len(c) <= max_k}
        if result != want:
            raise SystemExit(f"residency[{backing}]: supports differ from "
                             f"mine_serial")
        spy.check_route(f"residency[{backing}]", launches,
                        met.sparse_sweeps, indexed=backing == "jax")
        if backing == "jax" and met.h2d_bytes < bitmaps.nbytes:
            raise SystemExit("residency[jax]: h2d below the base payload")
        log(f"residency mine[bucket, auto, max_k={max_k}, arena={backing}]:"
            f" wall_s={wall:.3f} flushes={met.flushes} "
            f"h2d_bytes={met.h2d_bytes} sparse_sweeps={met.sparse_sweeps} "
            f"dense_sweeps={met.dense_sweeps} "
            f"launches={json.dumps(launches)} all through the "
            f"{'gathered forms' if backing == 'numpy' else 'indexed entries'}"
            f"; supports==mine_serial ok")
        spy.hold(f"residency[{backing}]")
        out[backing] = launches
    return out


def phase_launcher():
    """The launcher's ``main``, as ``python -m repro_torch.launch.
    fpm_mine`` calls it, in this process: the launch counts are set to 0
    just before it and read just after. The launcher checks each policy
    against ``mine_serial`` itself and prints its lines here. Returns
    the launches."""
    from repro_torch.launch import fpm_mine
    argv = ["--dataset", "t10i4", "--policies", "cilk", "clustered",
            "--max-k", str(MAIN_MAX_K), "--trace-summary"]
    log(f"launcher: python -m repro_torch.launch.fpm_mine {' '.join(argv)}")
    with EntrySpy() as spy:
        reset_launches()
        t0 = time.perf_counter()
        fpm_mine.main(argv)
        wall = time.perf_counter() - t0
        launches = counted_launches()
    if min(launches.values()) == 0:
        raise SystemExit(f"launcher: a kernel never launched: {launches}")
    spy.check_route("launcher", launches, True, indexed=True)
    log(f"launcher: both policies equal mine_serial in {wall:.1f} s; "
        f"launches={json.dumps(launches)}, all through the indexed "
        f"entries")
    spy.hold("launcher")
    return launches


STREAM_INITIAL = 90_000        # phase 13: mined first, then 2 ingests
STREAM_BATCHES = ((90_000, 95_000), (95_000, 100_000))


def phase_stream(dev, db, n_items, bitmaps, min_support, serial,
                 granularity, max_k, label):
    """Streaming on the card (phase 13, and at depth-first grain the
    smaller stream): ``StreamingMiner`` over the first 90,000 phase-3
    transactions with ``arena="jax"``, refreshed, then the last 10,000
    ingested in two batches, each followed by a refresh (the default
    ``compact_ratio`` folds the refreshed segments at each publish).
    The launch counts are set to 0 just before and read just after.
    Each ingest must bill exactly its segment's payload, the final
    supports must equal ``mine_serial``, the dense kernel must have run
    on more than one segment (and, at bucket grain, with tuple
    prefixes), and the sparse kernel whenever a sweep was sparse.
    Returns (launches, miner, spy): the caller serves on the miner and
    closes it."""
    from repro_torch.core import streaming as ts
    with EntrySpy() as spy:
        reset_launches()
        t0 = time.perf_counter()
        sm = ts.StreamingMiner(
            n_items, min_support, initial_db=db[:STREAM_INITIAL],
            device=dev, policy="clustered", n_workers=8, max_k=max_k,
            granularity=granularity, arena="jax", representation="auto")
        log(f"{label}: StreamingMiner over {STREAM_INITIAL} transactions "
            f"(arena='jax', {granularity}, max_k={max_k}) built in "
            f"{time.perf_counter() - t0:.2f} s; h2d at load "
            f"{sm.arena.h2d_bytes} B == seg_nbytes(0) "
            f"{sm.arena.seg_nbytes(0)} B")
        disp = sm.runtime.dispatchers[0]
        sparse = 0

        def refreshed(tag):
            nonlocal sparse
            f0, r0 = disp.flushes, disp.requests
            rep = sm.refresh()
            met = rep.metrics
            sparse += met.sparse_sweeps
            flushes, reqs = disp.flushes - f0, disp.requests - r0
            log(f"  {tag}: refresh gen {rep.generation} wall_s="
                f"{rep.wall_s:.3f} |D|={rep.n_transactions} "
                f"frequent={rep.frequent} segments={rep.segments_refreshed}"
                f" dirty_items={rep.dirty_items} rows={rep.rows_touched} "
                f"bytes_swept={rep.bytes_swept} reused={rep.reused} "
                f"delta={rep.swept_delta} full={rep.swept_full} "
                f"born={rep.born} died={rep.died} h2d={rep.h2d_bytes} B "
                f"compacted={rep.compacted_segments} "
                f"compaction_bytes={rep.compaction_bytes} "
                f"flushes={flushes} occupancy={reqs / max(flushes, 1):.2f} "
                f"dense_sweeps={met.dense_sweeps} "
                f"sparse_sweeps={met.sparse_sweeps}")
            return rep

        refreshed("initial")
        for lo, hi in STREAM_BATCHES:
            ing = sm.ingest(db[lo:hi])
            if not (ing.h2d_bytes == ing.payload_bytes
                    == sm.arena.seg_nbytes(ing.segment)):
                raise SystemExit(f"{label}: ingest of {hi - lo} "
                                 f"transactions billed {ing.h2d_bytes} B, "
                                 f"not seg_nbytes "
                                 f"{sm.arena.seg_nbytes(ing.segment)} B")
            log(f"  ingest [{lo}, {hi}): segment {ing.segment}, "
                f"W_seg={ing.words}, wall_s={ing.wall_s:.3f}, h2d="
                f"{ing.h2d_bytes} B == seg_nbytes ok")
            refreshed(f"+{hi - lo} tx")
        launches = counted_launches()
    want = {c: v for c, v in serial.items() if len(c) <= max_k}
    if dict(sm.snapshot.supports) != want:
        sm.close()
        raise SystemExit(f"{label}: final supports differ from mine_serial")
    spy.check_route(label, launches, sparse, indexed=True)
    # the levelwise delta path sweeps dirty buckets as base-item tuples;
    # a depth-first class sweeps its own handed row, never a tuple
    tuples = sum(spy.tuple_shapes.values())
    if (granularity != "depth-first" and not tuples) or len(spy.widths) < 2:
        sm.close()
        raise SystemExit(f"{label}: bitmap_join_many ran {tuples} tuple-"
                         f"prefix launches over segment widths "
                         f"{dict(spy.widths)}")
    log(f"{label}: final supports == mine_serial ({len(want)} itemsets) "
        f"ok; launches={json.dumps(launches)} (sparse_sweeps={sparse}); "
        f"bitmap_join_many launches per segment width "
        f"{dict(spy.widths)}, {tuples} with tuple prefixes; tuple shapes "
        f"(B', L, E', W_seg): {dict(spy.tuple_shapes.most_common(8))}")
    spy.hold(label)
    return launches, sm, spy


def phase_serve(sm, db, bitmaps, serial):
    """Serving on phase 13's final generation, the launch counts set to
    0 just before and read just after: 256 ``support`` hits, 256
    ``top_k(prefix, 5)`` ranked on the card (each equal to the host
    ranking) and 256 ``support_many`` batches of 8 never-counted
    itemsets (each equal to a host AND-popcount over the packed
    bitmaps). Returns the launches."""
    import numpy as np
    from repro_torch.core import streaming as ts
    from repro_torch.core.tidlist import support_of
    rng = np.random.default_rng(13)
    snap = sm.snapshot
    if len(snap.supports) < ts.TOPK_DEVICE_MIN:
        raise SystemExit(f"serve: {len(snap.supports)} itemsets do not "
                         f"reach the device top-k path")
    known = sorted(x for x in snap.supports if len(x) >= 2)
    hits = [known[i] for i in rng.choice(len(known), 256, replace=False)]
    prefixes = [x[:1 + i % 2] for i, x in enumerate(hits)]
    host_index = ts._SnapshotIndex(snap.supports, "cpu")
    saved, ts.TOPK_DEVICE_MIN = ts.TOPK_DEVICE_MIN, len(snap.supports) + 1
    try:
        host_top = [host_index.top_k(p, 5) for p in prefixes]
    finally:
        ts.TOPK_DEVICE_MIN = saved
    seen, fresh = set(), []
    while len(fresh) < 256 * 8:
        t = db[int(rng.integers(len(db)))]
        if len(t) < 3:
            continue
        k = int(rng.integers(3, min(6, len(t)) + 1))
        x = tuple(sorted(int(i) for i in rng.choice(t, k, replace=False)))
        if x not in seen and snap.lookup(x) is None:
            seen.add(x)
            fresh.append(x)
    srv = ts.PatternServer(sm)
    lat = {"hit": [], "top_k": [], "sweep": []}
    with EntrySpy() as spy:
        reset_launches()
        for x in hits:
            t0 = time.perf_counter()
            got = srv.support(x)
            lat["hit"].append(time.perf_counter() - t0)
            if got != serial[x]:
                raise SystemExit(f"serve: support{x} = {got}, not "
                                 f"{serial[x]}")
        for p, want in zip(prefixes, host_top):
            t0 = time.perf_counter()
            got = srv.top_k(p, 5)
            lat["top_k"].append(time.perf_counter() - t0)
            if got != want:
                raise SystemExit(f"serve: top_k({p}, 5) on the card "
                                 f"{got} differs from the host's {want}")
        answers = []
        for i in range(0, len(fresh), 8):
            t0 = time.perf_counter()
            answers += srv.support_many(fresh[i:i + 8])
            lat["sweep"].append((time.perf_counter() - t0) / 8)
        launches = counted_launches()
    dev_index = snap._index._dev
    if dev_index is None or not dev_index[0].is_cuda:
        raise SystemExit("serve: top_k did not rank on the card")
    want = [support_of(bitmaps[list(x)]) for x in fresh]
    if answers != want:
        bad = sum(a != w for a, w in zip(answers, want))
        raise SystemExit(f"serve: {bad} swept supports differ from the "
                         f"host AND-popcount")
    stats = srv.merged_stats()
    if (stats["hit"], stats["top_k"], stats["sweep"]) != (256, 256, 2048):
        raise SystemExit(f"serve: per-kind counts {stats}")
    spy.check_route("serve", launches, 0, indexed=True)
    if launches["gather_intersect_many"]:
        raise SystemExit(f"serve: query sweeps are dense: {launches}")
    for kind, xs in lat.items():
        a = np.asarray(xs) * 1e3
        log(f"serve {kind}: n={len(xs)} p50={np.percentile(a, 50):.4f} ms "
            f"p99={np.percentile(a, 99):.4f} ms (per query, host clock)")
    log(f"serve: 256 hits == mine_serial, 256 top_k on the card == host "
        f"ranking, 2048 never-counted itemsets == host AND-popcount "
        f"(max support {max(answers)}) ok; stats={stats} query_sweeps="
        f"{sm.query_sweeps} query_sweep_bytes={sm.query_sweep_bytes} "
        f"launches={json.dumps(launches)}; tuple shapes (B', L, E', "
        f"W_seg): {dict(spy.tuple_shapes.most_common(4))}")
    spy.hold("serve")
    return launches


def phase_launcher_stream():
    """Phase 14: the launcher's ``main`` with ``--dataset t10i4 --stream
    2 --serve 64 --max-k 6`` in this process, the launch counts set to
    0 just before and read just after; the launcher checks the final
    generation against ``mine_serial`` itself. Returns the launches."""
    from repro_torch.launch import fpm_mine
    argv = ["--dataset", "t10i4", "--stream", "2", "--serve", "64",
            "--max-k", str(MAIN_MAX_K)]
    log(f"launcher-stream: python -m repro_torch.launch.fpm_mine "
        f"{' '.join(argv)}")
    with EntrySpy() as spy:
        reset_launches()
        t0 = time.perf_counter()
        fpm_mine.main(argv)
        wall = time.perf_counter() - t0
        launches = counted_launches()
    spy.check_route("launcher-stream", launches, True, indexed=True)
    if not sum(spy.tuple_shapes.values()):
        raise SystemExit("launcher-stream: no tuple-prefix launch")
    log(f"launcher-stream: the stream's final generation equals "
        f"mine_serial in {wall:.1f} s; launches={json.dumps(launches)}, "
        f"all through the indexed entries, "
        f"{sum(spy.tuple_shapes.values())} with tuple prefixes")
    spy.hold("launcher-stream")
    return launches


class HostSpy:
    """Wraps the cluster's hooks for one phase: each ``TorchBackend.
    sweep_many`` call is attributed to the arena it sweeps, as an origin
    flush or, inside the peer evaluator, a peer evaluation, and each
    ``bitmap_join_many`` indexed call under it is counted per (arena,
    role). Keeps the first peer-evaluation tuple-prefix call's arguments
    (pidx [B, L]) and the run's ``ClusterGauges``. Enter it inside an
    ``EntrySpy``, so that both see every call."""

    def __enter__(self):
        import threading
        from repro_torch.core import cluster, join_backend
        self.local = threading.local()
        self.calls = collections.Counter()
        self.peer_tuple = None
        self.gauges = None
        self.targets = [(join_backend.TorchBackend, "sweep_many"),
                        (cluster._PeerEval, "__call__"),
                        (cluster.LoopbackContext, "reduce_flush"),
                        (join_backend, "bitmap_join_many_rows")]
        self.originals = [getattr(o, n) for o, n in self.targets]
        sweep_many, peer_eval, reduce_flush, rows = self.originals
        spy = self

        def swept(backend, arena, requests):
            prev = getattr(spy.local, "arena", None)
            spy.local.arena = arena
            try:
                return sweep_many(backend, arena, requests)
            finally:
                spy.local.arena = prev

        def peer(evaluator, descs):
            spy.local.peer = True
            try:
                return peer_eval(evaluator, descs)
            finally:
                spy.local.peer = False

        def reduced(ctx, requests, results):
            spy.gauges = ctx.gauges
            return reduce_flush(ctx, requests, results)

        def launched(*args):
            role = "peer" if getattr(spy.local, "peer", False) else "origin"
            spy.calls[(id(spy.local.arena), role)] += 1
            if (role == "peer" and args[1].dim() == 2
                    and spy.peer_tuple is None):
                store = args[0].clone()
                spy.peer_tuple = (store, args[1].clone(), store,
                                  args[3].clone(), args[4])
            return rows(*args)

        for (obj, name), fn in zip(self.targets,
                                   (swept, peer, reduced, launched)):
            setattr(obj, name, fn)
        return self

    def __exit__(self, *exc):
        for (obj, name), fn in zip(self.targets, self.originals):
            setattr(obj, name, fn)

    def take(self):
        """{role: {arena id: dense launches}} since the last take."""
        out = {"origin": {}, "peer": {}}
        for (arena, role), n in self.calls.items():
            out[role][arena] = n
        self.calls.clear()
        return out

    def check_hosts(self, label, hosts, one_owner=False):
        """Every host's mirror took both its own flushes and peer
        evaluations — or, with every bucket on one host (``one_owner``),
        that host's mirror its flushes and the other's the peer
        evaluations of them (a stolen bucket still sweeps through its
        origin's dispatcher). Returns the per-role launch counts."""
        seen = self.take()
        origin, peer = set(seen["origin"]), set(seen["peer"])
        ok = ((len(origin), len(peer)) == (1, hosts - 1)
              and not origin & peer) if one_owner else (
            len(origin) == hosts and origin == peer)
        if not ok:
            raise SystemExit(f"{label}: bitmap_join_many launches per host "
                             f"mirror {seen} over {hosts} hosts")
        return {r: sorted(v.values()) for r, v in seen.items()}

    def hold(self, label):
        """The first peer-evaluation tuple call against its plain
        version."""
        import torch
        from repro_torch.kernels.bitmap_join import ops as bj
        from repro_torch.kernels.bitmap_join.ref import (
            bitmap_join_many_rows_ref)
        args = self.peer_tuple
        if args is None:
            raise SystemExit(f"{label}: no peer evaluation made a "
                             f"tuple-prefix launch")
        got = bj.bitmap_join_many_rows(*args)
        want = bitmap_join_many_rows_ref(*args)
        torch.cuda.synchronize()
        shape = describe("bitmap_join_many", args)
        if not torch.equal(got, want):
            raise SystemExit(f"{label}: a peer evaluation's tuple-prefix "
                             f"bitmap_join_many disagrees with its plain "
                             f"version at {shape}")
        log(f"  {label}: bitmap_join_many at the first peer evaluation "
            f"with tuple prefixes ({shape}): equals its plain version ok")


def log_cluster(label, wall, met, extra=""):
    hosts = "; ".join(
        f"host {h['host']}: bytes_swept={h['bytes_swept']} "
        f"sweep_s={h['sweep_s']:.3f} eval_s={h['eval_s']:.3f} "
        f"eval_bytes={h['eval_bytes']}" for h in met.per_host)
    log(f"{label}: wall_s={wall:.3f} flushes={met.flushes} "
        f"occupancy={met.batch_occupancy:.2f} net_bytes={met.net_bytes} "
        f"steal_net={met.steal_net} cross_steals={met.cross_steals} "
        f"{extra}[{hosts}]")


def spied(run):
    """``run()`` with the backend's kernel entries (``EntrySpy``) and the
    cluster's hooks (``HostSpy``) spied on, the launch counts set to 0
    just before and read just after. Returns ``run()``'s result, its
    wall, the launches and both spies."""
    with EntrySpy() as spy, HostSpy() as hosts:
        reset_launches()
        t0 = time.perf_counter()
        out = run()
        wall = time.perf_counter() - t0
        launches = counted_launches()
    return out, wall, launches, spy, hosts


def phase_cluster(dev, bitmaps, counts, min_support, serial, bitmap_met):
    """Phase 15: the multi-host mine on the card, four runs, each with
    the launch counts set to 0 just before it and read just after it:
    ``repro_torch.mine(hosts=2)`` at bucket grain and max_k=6 (supports
    equal ``mine_serial``, one reduction per flush, bytes on the
    interconnect, ``bitmap_join_many`` launched on both hosts' mirrors
    by their own flushes and by peer evaluations with tuple prefixes),
    then at max_k=4 three hosts, depth-first grain and a forced
    cross-host steal (of up to three attempts, only the one kept is
    counted). Returns the launches of each run, by column."""
    import repro_torch
    from repro_torch.core import cluster
    want4 = {c: v for c, v in serial.items() if len(c) <= BITMAP_MAX_K}
    runs = [
        ("cluster", "hosts=2, bucket", MAIN_MAX_K, dict(hosts=2)),
        ("cluster-3", "hosts=3, bucket", BITMAP_MAX_K, dict(hosts=3)),
        ("cluster-depth-first", "hosts=2, depth-first", BITMAP_MAX_K,
         dict(hosts=2, granularity="depth-first")),
        ("cluster-steal", "hosts=2, bucket, every bucket on host 0",
         BITMAP_MAX_K, dict(hosts=2, owner_fn=lambda key: 0)),
    ]
    columns = {}
    for column, label, max_k, kw in runs:
        steal = "owner_fn" in kw
        entry = repro_torch.mine if column == "cluster" else (
            cluster.mine_cluster)
        for attempt in range(3):
            (result, met), wall, launches, spy, hosts = spied(
                lambda: entry(bitmaps, min_support, device=dev,
                              policy="clustered", max_k=max_k,
                              item_counts=counts,
                              **{"granularity": "bucket", **kw}))
            if not steal or met.cross_steals > 0:
                break
            log(f"  cluster[{label}]: no cross-host steal in attempt "
                f"{attempt + 1}; again")
        if result != (serial if max_k == MAIN_MAX_K else want4):
            raise SystemExit(f"cluster[{label}]: supports differ from "
                             f"mine_serial")
        if steal and not (met.cross_steals > 0 and met.steal_net > 0):
            raise SystemExit(f"cluster[{label}]: no cross-host steal in "
                             f"3 runs")
        g = hosts.gauges.snapshot()
        extra = ""
        if column == "cluster":
            if g["reduced_flushes"] != met.flushes or met.net_bytes <= 0:
                raise SystemExit(f"cluster: {g['reduced_flushes']} "
                                 f"reductions for {met.flushes} flushes, "
                                 f"net_bytes {met.net_bytes}")
            extra = f"reduced_flushes={g['reduced_flushes']} "
        per_role = hosts.check_hosts(f"cluster[{label}]", kw["hosts"],
                                     one_owner=steal)
        spy.check_route(f"cluster[{label}]", launches, 0, indexed=True)
        log_cluster(f"cluster mine[{label}, max_k={max_k}]", wall, met,
                    f"{extra}bitmap_join_many per host mirror {per_role} ")
        log(f"  cluster[{label}]: launches={json.dumps(launches)}, all "
            f"through the indexed entries; tuple shapes (B', L, E', "
            f"W_seg): {dict(spy.tuple_shapes.most_common(4))}")
        if column == "cluster":
            log(f"  against phase 4 (one host, bitmap, max_k="
                f"{BITMAP_MAX_K}): wall_s={bitmap_met.wall_s:.3f} "
                f"flushes={bitmap_met.flushes} "
                f"occupancy={bitmap_met.batch_occupancy:.2f}; "
                f"supports==mine_serial ok")
            hosts.hold("cluster")
        spy.hold(f"cluster[{label}]")
        columns[column] = launches
    return columns


def phase_cluster_stream(dev, db, n_items, min_support, serial):
    """Phase 16: ``StreamingMiner(hosts=2)`` on phase 13's stream at
    max_k=4 (``arena="jax"``), the launch counts set to 0 just before and
    read just after: each ingest bills its segment's payload on the
    owner host and nothing on the peer, and the final supports equal
    ``mine_serial``. Returns the launches."""
    from repro_torch.core import streaming as ts
    want = {c: v for c, v in serial.items() if len(c) <= BITMAP_MAX_K}
    with EntrySpy() as spy, HostSpy() as hosts:
        reset_launches()
        t0 = time.perf_counter()
        sm = ts.StreamingMiner(
            n_items, min_support, initial_db=db[:STREAM_INITIAL],
            device=dev, policy="clustered", n_workers=8,
            max_k=BITMAP_MAX_K, granularity="bucket", arena="jax", hosts=2)
        try:
            loaded = [ar.h2d_bytes for ar in sm._harenas]
            log(f"cluster-stream: StreamingMiner(hosts=2) over "
                f"{STREAM_INITIAL} transactions (arena='jax', bucket, "
                f"max_k={BITMAP_MAX_K}) built in "
                f"{time.perf_counter() - t0:.2f} s; h2d at load per host "
                f"{loaded} B")
            rep = sm.refresh()
            log_cluster(f"  initial: refresh gen {rep.generation}",
                        rep.wall_s, rep.metrics,
                        f"frequent={rep.frequent} rows={rep.rows_touched} ")
            for lo, hi in STREAM_BATCHES:
                h0 = [ar.h2d_bytes for ar in sm._harenas]
                ing = sm.ingest(db[lo:hi])
                billed = [ar.h2d_bytes - h
                          for ar, h in zip(sm._harenas, h0)]
                if sorted(billed) != [0, ing.payload_bytes] or (
                        ing.h2d_bytes != ing.payload_bytes):
                    raise SystemExit(f"cluster-stream: ingest of "
                                     f"{hi - lo} transactions billed "
                                     f"{billed} B per host, not "
                                     f"{ing.payload_bytes} B on one")
                log(f"  ingest [{lo}, {hi}): segment {ing.segment}, "
                    f"W_seg={ing.words}, h2d per host {billed} B: the "
                    f"payload on the owner, 0 on the peer ok")
                rep = sm.refresh()
                log_cluster(f"  +{hi - lo} tx: refresh gen {rep.generation}",
                            rep.wall_s, rep.metrics,
                            f"dirty_items={rep.dirty_items} "
                            f"reused={rep.reused} delta={rep.swept_delta} "
                            f"full={rep.swept_full} ")
            if dict(sm.snapshot.supports) != want:
                raise SystemExit("cluster-stream: final supports differ "
                                 "from mine_serial")
            gauges = sm.cluster_gauges
        finally:
            sm.close()
        per_role = hosts.check_hosts("cluster-stream", 2)
        launches = counted_launches()
    spy.check_route("cluster-stream", launches, 0, indexed=True)
    log(f"cluster-stream: final supports == mine_serial ({len(want)} "
        f"itemsets) ok; lifetime gauges {gauges}; launches="
        f"{json.dumps(launches)}; bitmap_join_many per host mirror "
        f"{per_role}, per segment width {dict(spy.widths)}")
    spy.hold("cluster-stream")
    hosts.hold("cluster-stream")
    return launches


TENANTS = {"a": ((0, 50_000), 4.0), "b": ((50_000, 100_000), 1.0)}
TENANT_INITIAL = 45_000
TENANT_BATCH = 2_500


def phase_tenants(dev, db, n_items, min_support):
    """Phase 17: a ``TenantHub`` on the card with two weighted tenants
    (``TENANTS``), the launch counts set to 0 just before and read just
    after. Each tenant mines its first 45,000 transactions, then ingests
    2 x 2,500, each followed by a refresh, the two tenants' refreshes
    running at once from two threads; during the second refresh 256
    ``support_many`` batches of 8 go to each tenant, each answer equal
    to a host AND-popcount over that tenant's refreshed data. Each final
    snapshot equals ``mine_serial`` of its own 50,000 transactions.
    Returns the launches."""
    import threading
    import numpy as np
    from repro_torch.core import fpm
    from repro_torch.core import streaming as ts
    from repro_torch.core.tidlist import pack_database, support_of
    frac = min_support / len(db)
    rng = np.random.default_rng(17)
    probes, counts = {}, {}
    for tid, ((lo, hi), _) in TENANTS.items():
        # never-counted itemsets (longer than max_k): every one sweeps
        xs = []
        while len(xs) < 256 * 8:
            t = db[int(rng.integers(lo, hi))]
            if len(t) >= BITMAP_MAX_K + 1:
                k = int(rng.integers(BITMAP_MAX_K + 1,
                                     min(7, len(t)) + 1))
                xs.append(tuple(sorted(int(i) for i in
                                       rng.choice(t, k, replace=False))))
        probes[tid] = xs
        # host counts over each boundary a query may see
        for n in (TENANT_INITIAL + TENANT_BATCH,
                  TENANT_INITIAL + 2 * TENANT_BATCH):
            words = pack_database(db[lo:lo + n], n_items)
            counts[tid, n] = [support_of(words[list(x)]) for x in xs]
    answers = {tid: [] for tid in TENANTS}
    errors = []
    with EntrySpy() as spy:
        reset_launches()
        t_all = time.perf_counter()
        hub = ts.TenantHub(n_items, device=dev, policy="clustered",
                           n_workers=8, max_k=BITMAP_MAX_K)
        try:
            tenants = {tid: hub.tenant(tid, frac, weight=w)
                       for tid, (_, w) in TENANTS.items()}

            def grow(tid, lo, hi):
                try:
                    t = tenants[tid]
                    t.ingest(db[lo:hi])
                    rep = t.refresh()
                    log(f"  tenant {tid}: +{hi - lo} tx, refresh gen "
                        f"{rep.generation} wall_s={rep.wall_s:.3f} "
                        f"frequent={rep.frequent} reused={rep.reused} "
                        f"delta={rep.swept_delta} full={rep.swept_full}")
                except BaseException as e:  # noqa: BLE001 - failed below
                    errors.append(e)

            def ask(tid):
                try:
                    t = tenants[tid]
                    xs = probes[tid]
                    for i in range(0, len(xs), 8):
                        with hub._state:
                            n = t.snapshot.n_transactions
                        t0 = time.perf_counter()
                        got = t.support_many(xs[i:i + 8])
                        answers[tid].append(
                            (n, i, got, time.perf_counter() - t0))
                except BaseException as e:  # noqa: BLE001 - failed below
                    errors.append(e)

            starts = {tid: lo for tid, ((lo, _), _) in TENANTS.items()}
            rounds = [(0, TENANT_INITIAL)] + [
                (TENANT_INITIAL + r * TENANT_BATCH,
                 TENANT_INITIAL + (r + 1) * TENANT_BATCH) for r in range(2)]
            for r, (a, b) in enumerate(rounds):
                threads = [threading.Thread(
                    target=grow, args=(tid, starts[tid] + a, starts[tid] + b))
                    for tid in TENANTS]
                if r == 2:
                    threads += [threading.Thread(target=ask, args=(tid,))
                                for tid in TENANTS]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                if errors:
                    raise errors[0]
            stats = hub.tenant_stats()
            snaps = {tid: t.snapshot for tid, t in tenants.items()}
        finally:
            hub.close()
        wall = time.perf_counter() - t_all
        launches = counted_launches()
    for tid, rows in answers.items():
        for n, i, got, _ in rows:
            want = [counts[tid, m][i:i + 8] for m in
                    (TENANT_INITIAL + TENANT_BATCH,
                     TENANT_INITIAL + 2 * TENANT_BATCH) if m >= n]
            if got not in want:
                raise SystemExit(f"tenants: tenant {tid}'s answers "
                                 f"{got} to batch {i // 8} are no host "
                                 f"count over its data")
        lat = np.asarray([r[3] for r in rows]) / 8 * 1e3
        log(f"tenants: tenant {tid}: {len(rows)} batches of 8 during the "
            f"second refresh == host AND-popcount ok; per query p50="
            f"{np.percentile(lat, 50):.4f} ms p99="
            f"{np.percentile(lat, 99):.4f} ms (host clock)")
    for tid, ((lo, hi), _) in TENANTS.items():
        snap = snaps[tid]
        want = fpm.mine_serial(pack_database(db[lo:hi], n_items),
                               snap.min_support, max_k=BITMAP_MAX_K)
        if dict(snap.supports) != want:
            raise SystemExit(f"tenants: tenant {tid}'s snapshot differs "
                             f"from mine_serial of its {hi - lo} "
                             f"transactions")
        log(f"tenants: tenant {tid}: snapshot gen {snap.generation} == "
            f"mine_serial of its {hi - lo} transactions at min_support "
            f"{snap.min_support} ({len(want)} itemsets) ok; "
            f"tenant_stats {stats[tid]}")
    spy.check_route("tenants", launches, 0, indexed=True)
    log(f"tenants: {wall:.1f} s in all; launches={json.dumps(launches)}, "
        f"tuple shapes (B', L, E', W_seg): "
        f"{dict(spy.tuple_shapes.most_common(4))}")
    spy.hold("tenants")
    return launches


def phase_hosts():
    """Phase 18: the launcher's ``main`` with ``--dataset t10i4 --hosts 2
    --max-k 6``: two rank processes on the one card over a TCPStore the
    launcher hosts. Rank 0 checks its result against ``mine_serial``;
    each rank prints its kernel launches, parsed here (the ranks are
    processes of their own, so their counts start at 0). A rank's
    non-zero exit fails the phase. Returns the launches of both ranks
    together."""
    import contextlib
    import io
    import re
    from repro_torch.launch import fpm_mine
    argv = ["--dataset", "t10i4", "--hosts", "2", "--policies", "clustered",
            "--max-k", str(MAIN_MAX_K)]
    log(f"hosts: python -m repro_torch.launch.fpm_mine {' '.join(argv)}")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        fpm_mine.main(argv)
    wall = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        log(f"  {line}")
    ranks = {int(r or 0): json.loads(j) for r, j in re.findall(
        r"^(?:rank (\d+): )?launches: (\{.*\})$", text, re.M)}
    if "equals mine_serial" not in text:
        raise SystemExit("hosts: rank 0 did not report its check against "
                         "mine_serial")
    if sorted(ranks) != [0, 1] or not all(
            r["bitmap_join_many"] > 0 for r in ranks.values()):
        raise SystemExit(f"hosts: rank launches {ranks}")
    launches = {k: sum(r[k] for r in ranks.values())
                for k in ("bitmap_join_many", "gather_intersect_many")}
    log(f"hosts: 2 ranks on the card in {wall:.1f} s (the launcher's wall, "
        f"process start included); launches per rank {ranks}")
    return launches


def phase_hosts_loopback(dev):
    """Phase 18's twin in one process: ``repro_torch.mine(hosts=2)`` on
    the launcher's own data (``t10i4`` at its 20,000 transactions, seed
    0) with the launcher's settings, the launch counts set to 0 just
    before and read just after, so that rank 0's wall stands beside a
    loopback mine of the same work. Returns the launches."""
    import repro_torch
    from repro_torch.core.fpm import mine_serial
    from repro_torch.core.tidlist import pack_database
    from repro_torch.data.transactions import load
    db, prof = load("t10i4", 0)
    bitmaps, counts = pack_database(db, prof.n_items, return_counts=True)
    ms = max(1, int(prof.support * len(db)))
    (result, met), wall, launches, spy, _ = spied(
        lambda: repro_torch.mine(bitmaps, ms, device=dev, hosts=2,
                                 policy="clustered", max_k=MAIN_MAX_K,
                                 item_counts=counts))
    if result != mine_serial(bitmaps, ms, max_k=MAIN_MAX_K):
        raise SystemExit("hosts-loopback: supports differ from mine_serial")
    spy.check_route("hosts-loopback", launches, 0, indexed=True)
    log_cluster(f"hosts-loopback: mine[hosts=2, bucket, max_k={MAIN_MAX_K}] "
                f"on the launcher's {len(db)} transactions", wall, met,
                f"launches={json.dumps(launches)} ")
    return launches


class ShardSpy:
    """Wraps the kernel backend for one mesh run: each ``TorchBackend.
    sweep_many`` call notes the arena it sweeps, and each call of an
    indexed entry under it is attributed to the shard whose mirror it was
    handed (the mirror tensor, argument 2, is one of that shard's
    per-segment mirrors). Counts launches per (kernel, shard) and
    tuple-prefix launches per shard, and keeps each (kernel, shard)'s
    first call for :meth:`hold`. Enter it inside an ``EntrySpy``, so that
    both see every call."""

    ENTRIES = ("bitmap_join_many_rows", "gather_intersect_many_rows")

    def __enter__(self):
        import threading
        import torch
        from repro_torch.core import join_backend
        self.local = threading.local()
        self.lock = threading.Lock()
        self.calls = collections.Counter()
        self.tuples = collections.Counter()
        self.first = {}
        self.targets = [(join_backend.TorchBackend, "sweep_many")] + [
            (join_backend, name) for name in self.ENTRIES]
        self.originals = [getattr(o, n) for o, n in self.targets]
        sweep_many = self.originals[0]
        spy = self

        def swept(backend, arena, requests):
            spy.local.arena = arena
            return sweep_many(backend, arena, requests)

        def wrap(name, fn):
            def call(*args):
                arena = spy.local.arena
                owner = [s for s in range(arena.n_shards)
                         for m in list(arena._mirrors[s].values())
                         if m.data_ptr() == args[2].data_ptr()]
                if len(owner) != 1:
                    raise SystemExit(f"{name}: a launch on a mirror of "
                                     f"shards {owner}, not of one shard")
                key = (name, owner[0])
                with spy.lock:
                    spy.calls[key] += 1
                    if name == "bitmap_join_many_rows" and args[1].dim() == 2:
                        spy.tuples[owner[0]] += 1
                    if key not in spy.first:
                        mirror = args[2].clone()
                        spy.first[key] = tuple(
                            mirror if a is args[2] else
                            a.clone() if isinstance(a, torch.Tensor) else a
                            for a in args)
                return fn(*args)
            return call

        setattr(join_backend.TorchBackend, "sweep_many", swept)
        for name, fn in zip(self.ENTRIES, self.originals[1:]):
            setattr(join_backend, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for (obj, name), fn in zip(self.targets, self.originals):
            setattr(obj, name, fn)

    def per_shard(self):
        """{kernel: [launches on shard 0, shard 1, ...]} (short names)."""
        shards = 1 + max((s for _, s in self.calls), default=0)
        return {name[:-len("_rows")]: [self.calls[(name, s)]
                                       for s in range(shards)]
                for name in self.ENTRIES}

    def check(self, label, shards, kernels=("bitmap_join_many_rows",)):
        """Each of ``kernels`` launched on every one of ``shards``
        shards' mirrors, and on no other."""
        seen = {s for _, s in self.calls}
        missing = [(k, s) for k in kernels for s in range(shards)
                   if not self.calls[(k, s)]]
        if missing or seen - set(range(shards)):
            raise SystemExit(f"{label}: launches per shard mirror "
                             f"{self.per_shard()}; missing {missing}")
        return self.per_shard()

    def hold(self, label):
        """Each (kernel, shard)'s first call against its plain version."""
        import torch
        from repro_torch.kernels.bitmap_join import ops as bj
        from repro_torch.kernels.bitmap_join import ref as bj_ref
        from repro_torch.kernels.gather_intersect import ops as gi
        from repro_torch.kernels.gather_intersect import ref as gi_ref
        for (name, shard), args in sorted(self.first.items()):
            ops, ref = (bj, bj_ref) if name.startswith("bitmap") else (
                gi, gi_ref)
            got = getattr(ops, name)(*args)
            want = getattr(ref, f"{name}_ref")(*args)
            torch.cuda.synchronize()
            shape = describe(name[:-len("_rows")], args)
            if not torch.equal(got, want):
                raise SystemExit(f"{label}: {name} on shard {shard}'s "
                                 f"mirror disagrees with its plain version "
                                 f"at {shape}")
            log(f"  {label}: {name} at its first call on shard {shard}'s "
                f"mirror ({shape}): equals its plain version ok")


def mesh_spied(run):
    """``run()`` with the backend's kernel entries spied on twice
    (``EntrySpy``, ``ShardSpy``), the launch counts set to 0 just before
    and read just after. Returns ``run()``'s result, its wall, the
    launches and both spies."""
    with EntrySpy() as spy, ShardSpy() as shards:
        reset_launches()
        t0 = time.perf_counter()
        out = run()
        wall = time.perf_counter() - t0
        launches = counted_launches()
    return out, wall, launches, spy, shards


def log_mesh(label, wall, met, base=None, extra=""):
    """One mesh run's line: wall (beside the phase ``base`` names), then
    per shard its flushes, occupancy and backend time."""
    shards = "; ".join(
        f"shard {d['device']}: flushes={d['flushes']} occupancy="
        f"{d['batch_occupancy']:.2f} sweep_s={d['sweep_s']:.3f}"
        for d in met.per_device)
    beside = f" (phase {base[0]}: {base[1]:.3f})" if base else ""
    log(f"{label}: wall_s={wall:.3f}{beside} "
        f"flushes={met.flushes} occupancy={met.batch_occupancy:.2f} "
        f"d2d_bytes={met.d2d_bytes} migrations={met.migrations} "
        f"steal_migrations={int(met.scheduler['steal_migrations'])} "
        f"{extra}[{shards}]")


def phase_mesh(dev, bitmaps, counts, min_support, serial, main_met,
               bitmap_met):
    """Phase 19: the mesh on the card, two logical shards (two mirrors,
    two dispatchers, two backends on the one card), each run with the
    launch counts set to 0 just before it and read just after it, and
    spied on by ``EntrySpy`` and ``ShardSpy``: ``repro_torch.mine(mesh=
    2)`` at bucket grain and max_k=6 (both batched kernels on each
    shard's mirror), then at max_k=4 candidate grain (every join through
    a shard's dispatcher), depth-first grain, every root class on shard
    0's workers (cross-shard steals must migrate handoff rows; of up to
    three attempts only the kept one is counted), a one-device mesh
    (``[cuda:0]`` at phase 4's settings: no d2d) and
    ``mine_distributed`` under both policies. Returns the launches of
    each run, by column."""
    import torch
    import repro_torch
    from repro_torch.core import scheduler
    row_bytes = bitmaps.shape[1] * 4
    want4 = {c: v for c, v in serial.items() if len(c) <= BITMAP_MAX_K}
    base_main, base4 = (3, main_met.wall_s), (4, bitmap_met.wall_s)
    columns = {}

    def mine(**kw):
        return repro_torch.mine(bitmaps, min_support, device=dev,
                                policy="clustered", item_counts=counts,
                                **{"granularity": "bucket", **kw})

    runs = [
        ("mesh", "mesh=2, bucket, auto", MAIN_MAX_K,
         lambda: mine(mesh=2, max_k=MAIN_MAX_K)),
        ("mesh-candidate", "mesh=2, candidate", BITMAP_MAX_K,
         lambda: mine(mesh=2, max_k=BITMAP_MAX_K, granularity="candidate")),
        ("mesh-depth-first", "mesh=2, depth-first", BITMAP_MAX_K,
         lambda: mine(mesh=2, max_k=BITMAP_MAX_K,
                      granularity="depth-first")),
        ("mesh-steal", "mesh=2, depth-first, every root on shard 0",
         BITMAP_MAX_K, lambda: mine(mesh=2, max_k=BITMAP_MAX_K,
                                    granularity="depth-first")),
        # phase 4's configuration, so that its wall stands beside phase 4's
        ("mesh-1", "mesh=[cuda:0], bucket, bitmap", BITMAP_MAX_K,
         lambda: mine(mesh=[torch.device("cuda:0")], max_k=BITMAP_MAX_K,
                      representation="bitmap")),
    ]
    for column, label, max_k, run in runs:
        steal = column == "mesh-steal"
        for attempt in range(3 if steal else 1):
            hashed = scheduler.stable_hash
            if steal:
                # a driver spawn goes to worker hash % 8: worker 0, shard 0
                scheduler.stable_hash = lambda key: 0
            try:
                (result, met), wall, launches, spy, shards = mesh_spied(run)
            finally:
                scheduler.stable_hash = hashed
            if not steal or (met.migrations > 0 and met.d2d_bytes > 0):
                break
            log(f"  mesh[{label}]: no migration in attempt {attempt + 1} "
                f"(steal_migrations="
                f"{int(met.scheduler['steal_migrations'])}); again")
        if result != (serial if max_k == MAIN_MAX_K else want4):
            raise SystemExit(f"mesh[{label}]: supports differ from "
                             f"mine_serial")
        n = 1 if column == "mesh-1" else 2
        if met.n_devices != n or not all(d["flushes"] > 0
                                         for d in met.per_device):
            raise SystemExit(f"mesh[{label}]: {met.n_devices} devices, "
                             f"per-shard gauges {met.per_device}")
        if steal and not (met.migrations > 0 and met.d2d_bytes > 0
                          and met.scheduler["steal_migrations"] > 0):
            raise SystemExit(f"mesh[{label}]: no cross-shard migration in "
                             f"3 runs")
        if column == "mesh-1" and met.d2d_bytes:
            raise SystemExit(f"mesh[{label}]: d2d_bytes={met.d2d_bytes} "
                             f"on one shard")
        if column == "mesh" and met.d2d_bytes % row_bytes:
            raise SystemExit(f"mesh[{label}]: d2d_bytes={met.d2d_bytes} "
                             f"is no whole number of {row_bytes}-byte rows")
        kernels = ShardSpy.ENTRIES if column == "mesh" else (
            "bitmap_join_many_rows",)
        per_shard = shards.check(f"mesh[{label}]", n, kernels)
        spy.check_route(f"mesh[{label}]", launches, met.sparse_sweeps,
                        indexed=True)
        log_mesh(f"mesh mine[{label}, max_k={max_k}]", wall, met,
                 base_main if max_k == MAIN_MAX_K else base4,
                 f"sparse_sweeps={met.sparse_sweeps} ")
        log(f"  mesh[{label}]: supports==mine_serial ok; launches="
            f"{json.dumps(launches)}, per shard mirror {per_shard}, all "
            f"through the indexed entries")
        spy.hold(f"mesh[{label}]")
        shards.hold(f"mesh[{label}]")
        columns[column] = launches
    for policy in ("clustered", "round_robin"):
        (result, stats), wall, launches, spy, shards = mesh_spied(
            lambda: repro_torch.mine_distributed(
                bitmaps, min_support, 2, policy=policy,
                max_k=BITMAP_MAX_K, device=dev))
        if result != want4 or stats["n_devices"] != 2:
            raise SystemExit(f"mesh-distributed[{policy}]: supports differ "
                             f"from mine_serial, or {stats['n_devices']} "
                             f"devices")
        per_shard = shards.check(f"mesh-distributed[{policy}]", 2)
        spy.check_route(f"mesh-distributed[{policy}]", launches, 0,
                        indexed=True)
        occ = "/".join(f"{d['batch_occupancy']:.2f}"
                       for d in stats["per_device"])
        log(f"mesh-distributed[{policy}, max_k={BITMAP_MAX_K}]: wall_s="
            f"{wall:.3f} (phase 4: {bitmap_met.wall_s:.3f}) rows_touched="
            f"{stats['rows_touched']} d2d_bytes={stats['d2d_bytes']} "
            f"migrations={stats['migrations']} dev_occ={occ}; supports=="
            f"mine_serial ok; launches={json.dumps(launches)}, per shard "
            f"mirror {per_shard}")
        spy.hold(f"mesh-distributed[{policy}]")
        columns[f"mesh-distributed-{policy.replace('_', '-')}"] = launches
    return columns


def phase_mesh_stream(dev, db, n_items, min_support, serial):
    """Phase 20: ``StreamingMiner(mesh=2)`` on phase 13's stream at
    max_k=4 (``arena="jax"``): each ingest bills the new segment's base
    rows once per shard (they are replicated, as the reference bills a
    two-shard arena), the final supports equal ``mine_serial``, the dense
    kernel runs tuple prefixes on both shards' mirrors, and 64
    ``support_many`` batches of 8 go out as priority sweeps on both
    shards' dispatchers, each answer equal to a host AND-popcount; then a
    ``TenantHub(mesh=2)`` with phase 17's two tenants (45,000 + 2 x 2,500
    transactions each), each final snapshot equal to ``mine_serial`` of
    its own data. Launch counts are set to 0 just before and read just
    after each. Returns the launches by column."""
    import numpy as np
    from repro_torch.core import fpm
    from repro_torch.core import streaming as ts
    from repro_torch.core.tidlist import pack_database, support_of
    want = {c: v for c, v in serial.items() if len(c) <= BITMAP_MAX_K}
    rng = np.random.default_rng(20)
    probes = []
    while len(probes) < 64 * 8:
        t = db[int(rng.integers(len(db)))]
        if len(t) > BITMAP_MAX_K:
            k = int(rng.integers(BITMAP_MAX_K + 1, min(7, len(t)) + 1))
            probes.append(tuple(sorted(int(i) for i in
                                       rng.choice(t, k, replace=False))))
    words = pack_database(db, n_items)
    host = [support_of(words[list(x)]) for x in probes]
    columns = {}

    def stream():
        sm = ts.StreamingMiner(
            n_items, min_support, initial_db=db[:STREAM_INITIAL],
            device=dev, policy="clustered", n_workers=8,
            max_k=BITMAP_MAX_K, granularity="bucket", arena="jax", mesh=2)
        try:
            n = sm.arena.n_shards
            if sm.arena.h2d_bytes != n * sm.arena.seg_nbytes(0):
                raise SystemExit(f"mesh-stream: h2d at load "
                                 f"{sm.arena.h2d_bytes} B, not {n} x "
                                 f"{sm.arena.seg_nbytes(0)} B")
            rep = sm.refresh()
            log_mesh(f"  initial {STREAM_INITIAL}: refresh gen "
                     f"{rep.generation}", rep.wall_s, rep.metrics,
                     extra=f"frequent={rep.frequent} ")
            for lo, hi in STREAM_BATCHES:
                ing = sm.ingest(db[lo:hi])
                if not (ing.h2d_bytes == n * ing.payload_bytes
                        == n * sm.arena.seg_nbytes(ing.segment)):
                    raise SystemExit(f"mesh-stream: ingest of {hi - lo} "
                                     f"transactions billed {ing.h2d_bytes}"
                                     f" B, not {n} x {ing.payload_bytes} B")
                log(f"  ingest [{lo}, {hi}): segment {ing.segment}, "
                    f"W_seg={ing.words}, h2d={ing.h2d_bytes} B == {n} "
                    f"shards x seg_nbytes ok")
                rep = sm.refresh()
                log_mesh(f"  +{hi - lo} tx: refresh gen {rep.generation}",
                         rep.wall_s, rep.metrics,
                         extra=f"reused={rep.reused} delta={rep.swept_delta} "
                         f"full={rep.swept_full} rep_d2d={rep.d2d_bytes} ")
            if dict(sm.snapshot.supports) != want:
                raise SystemExit("mesh-stream: final supports differ from "
                                 "mine_serial")
            srv = ts.PatternServer(sm)
            q0 = [d.query_requests for d in sm._runtime.dispatchers]
            answers = []
            for i in range(0, len(probes), 8):
                answers += srv.support_many(probes[i:i + 8])
            q = [d.query_requests - a
                 for d, a in zip(sm._runtime.dispatchers, q0)]
            if answers != host or min(q) == 0:
                raise SystemExit(f"mesh-stream: swept answers equal the "
                                 f"host's: {answers == host}; query "
                                 f"requests per shard {q}")
            log(f"  serve: 64 batches of 8 never-counted itemsets == host "
                f"AND-popcount ok; priority requests per shard {q}")
        finally:
            sm.close()

    _, wall, launches, spy, shards = mesh_spied(stream)
    per_shard = shards.check("mesh-stream", 2)
    if min(shards.tuples[s] for s in (0, 1)) == 0:
        raise SystemExit(f"mesh-stream: tuple-prefix launches per shard "
                         f"{dict(shards.tuples)}")
    spy.check_route("mesh-stream", launches, 0, indexed=True)
    log(f"mesh-stream: StreamingMiner(mesh=2) over {STREAM_INITIAL} "
        f"transactions and {len(STREAM_BATCHES)} ingests in {wall:.1f} s; "
        f"final supports == mine_serial ({len(want)} itemsets) ok; launches="
        f"{json.dumps(launches)}, per shard mirror {per_shard}, tuple "
        f"prefixes per shard {dict(shards.tuples)}")
    spy.hold("mesh-stream")
    shards.hold("mesh-stream")
    columns["mesh-stream"] = launches

    frac = min_support / len(db)

    def tenants():
        hub = ts.TenantHub(n_items, device=dev, policy="clustered",
                           n_workers=8, max_k=BITMAP_MAX_K, mesh=2)
        try:
            ts_ = {tid: hub.tenant(tid, frac, weight=w)
                   for tid, (_, w) in TENANTS.items()}
            rounds = [(0, TENANT_INITIAL)] + [
                (TENANT_INITIAL + r * TENANT_BATCH,
                 TENANT_INITIAL + (r + 1) * TENANT_BATCH) for r in range(2)]
            for a, b in rounds:
                for tid, ((lo, _), _) in TENANTS.items():
                    ts_[tid].ingest(db[lo + a:lo + b])
                for tid, rep in hub.refresh_all().items():
                    log_mesh(f"  tenant {tid}: +{b - a} tx, refresh gen "
                             f"{rep.generation}", rep.wall_s, rep.metrics,
                             extra=f"frequent={rep.frequent} ")
            return {tid: t.snapshot for tid, t in ts_.items()}
        finally:
            hub.close()

    snaps, wall, launches, spy, shards = mesh_spied(tenants)
    for tid, ((lo, hi), _) in TENANTS.items():
        snap = snaps[tid]
        mine = fpm.mine_serial(pack_database(db[lo:hi], n_items),
                               snap.min_support, max_k=BITMAP_MAX_K)
        if dict(snap.supports) != mine:
            raise SystemExit(f"mesh-tenants: tenant {tid}'s snapshot "
                             f"differs from mine_serial of its data")
        log(f"mesh-tenants: tenant {tid}: snapshot gen {snap.generation} "
            f"== mine_serial of its {hi - lo} transactions ({len(mine)} "
            f"itemsets) ok")
    per_shard = shards.check("mesh-tenants", 2)
    spy.check_route("mesh-tenants", launches, 0, indexed=True)
    log(f"mesh-tenants: TenantHub(mesh=2) in {wall:.1f} s; launches="
        f"{json.dumps(launches)}, per shard mirror {per_shard}")
    spy.hold("mesh-tenants")
    shards.hold("mesh-tenants")
    columns["mesh-tenants"] = launches
    return columns


def phase_launcher_mesh():
    """Phase 21: the launcher's ``main`` with ``--dataset t10i4 --mesh 2
    --policies clustered --max-k 6`` in this process, the launch counts
    set to 0 just before and read just after; it checks ``mine_serial``
    itself. Its ``mesh:`` line and ``d2d=``, ``migrations=`` and
    ``dev_occ=`` columns must be printed. Returns the launches."""
    import contextlib
    import io
    import re
    from repro_torch.launch import fpm_mine
    argv = ["--dataset", "t10i4", "--mesh", "2", "--policies", "clustered",
            "--max-k", str(MAIN_MAX_K)]
    log(f"launcher-mesh: python -m repro_torch.launch.fpm_mine "
        f"{' '.join(argv)}")
    out = io.StringIO()
    with EntrySpy() as spy, ShardSpy() as shards:
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            fpm_mine.main(argv)
        wall = time.perf_counter() - t0
        launches = counted_launches()
    text = out.getvalue()
    for line in text.splitlines():
        log(f"  {line}")
    if ("mesh: 2 device shards" not in text or not re.search(
            r"^clustered .* d2d=\d+B migrations=\d+ dev_occ=[\d.]+/[\d.]+",
            text, re.M)):
        raise SystemExit("launcher-mesh: no mesh line or mesh columns")
    per_shard = shards.check("launcher-mesh", 2)
    spy.check_route("launcher-mesh", launches, True, indexed=True)
    log(f"launcher-mesh: equals mine_serial in {wall:.1f} s; launches="
        f"{json.dumps(launches)}, per shard mirror {per_shard}")
    spy.hold("launcher-mesh")
    return launches


QUICK_MAX_K = 3                # phase 22 (the script's own: 4)


class CallSpy:
    """Wraps a script's mine entry points for one phase, so that each
    call is timed and counted apart: for each call, in order, its label
    (``label(name, args, kwargs)``), wall, the launches made during it
    (the counters read just before and just after; the calls do not
    overlap) and its result. The call whose label is ``record`` runs
    with a ``Recorder`` on each indexed entry, for phase 9's timing at
    the script's shapes (``recorders``)."""

    def __init__(self, targets, label, record=None):
        self.targets = targets
        self.label = label
        self.record = record
        self.calls = []
        self.recorders = {}

    def __enter__(self):
        self.originals = [getattr(o, n) for o, n in self.targets]
        for (owner, name), fn in zip(self.targets, self.originals):
            setattr(owner, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for (owner, name), fn in zip(self.targets, self.originals):
            setattr(owner, name, fn)

    def _wrap(self, name, fn):
        from repro_torch.core import join_backend

        def call(*args, **kw):
            label = self.label(name, args, kw)
            recs = {}
            if label == self.record:
                recs = {"bitmap_join_many": Recorder(
                            join_backend.bitmap_join_many_rows, False),
                        "gather_intersect_many": Recorder(
                            join_backend.gather_intersect_many_rows, True)}
                for kernel, rec in recs.items():
                    setattr(join_backend, f"{kernel}_rows", rec)
            before = counted_launches()
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kw)
            finally:
                for kernel, rec in recs.items():
                    setattr(join_backend, f"{kernel}_rows", rec.fn)
                    rec.freeze()
            wall = time.perf_counter() - t0
            after = counted_launches()
            self.recorders.update(recs)
            self.calls.append((label, wall, {k: after[k] - before[k]
                                             for k in after}, out))
            return out
        return call


def phase_quickstart(dev):
    """Phase 22: ``examples/torch_quickstart.py``'s ``run`` on the card
    at chess's full size and max_k=3: the serial reference, Cilk and
    clustered at candidate grain (host joins, as on one device the
    reference's are), then candidate, bucket and depth-first grain under
    the clustered policy, each checked equal to ``mine_serial`` by the
    script and again here. Each mine is timed and counted alone
    (``CallSpy``); the bucket mine's launches are recorded for phase 9's
    row at the chess shape. Returns (launches, recorders)."""
    import torch_quickstart as tq
    log(f"quickstart: examples/torch_quickstart.py run(max_k="
        f"{QUICK_MAX_K}) (the script's own max_k is 4)")
    calls = CallSpy([(tq, "mine")],
                    lambda _, a, kw: f"{kw['granularity']}/{kw['policy']}",
                    record="bucket/clustered")
    with EntrySpy() as spy, calls:
        reset_launches()
        t0 = time.perf_counter()
        done = tq.run(dev, max_k=QUICK_MAX_K, out=log)
        wall = time.perf_counter() - t0
        launches = counted_launches()
    sparse = 0
    for label, run_wall, got, (res, met) in calls.calls:
        if res != done["serial"]:
            raise SystemExit(f"quickstart[{label}]: supports differ from "
                             f"mine_serial")
        if label.startswith("candidate") and any(got.values()):
            raise SystemExit(f"quickstart[{label}]: a one-device candidate "
                             f"mine launched {got}; its joins are host "
                             f"joins")
        sparse += met.sparse_sweeps
        s = met.scheduler
        log(f"quickstart mine[{label}, max_k={QUICK_MAX_K}]: wall_s="
            f"{run_wall:.3f} cache_hit_rate={met.cache_hit_rate:.4f} "
            f"cache_hits={met.cache_hits} cache_misses={met.cache_misses} "
            f"steals={int(s['steals'])} tasks/steal="
            f"{s['tasks_per_steal']:.2f} tasks={int(s['tasks_run'])} "
            f"rows_touched={met.rows_touched} flushes={met.flushes} "
            f"occupancy={met.batch_occupancy:.2f} h2d_bytes={met.h2d_bytes} "
            f"peak_retained_bitmaps={met.peak_retained_bitmaps} "
            f"launches={json.dumps(got)} supports==mine_serial ok")
    spy.check_route("quickstart", launches, sparse, indexed=True)
    for label in ("bucket/clustered", "depth-first/clustered"):
        if not next(g for lab, _, g, _ in calls.calls
                    if lab == label)["bitmap_join_many"]:
            raise SystemExit(f"quickstart[{label}]: bitmap_join_many never "
                             f"launched")
    log(f"quickstart: {len(done['serial'])} itemsets, every run == "
        f"mine_serial in {wall:.1f} s; launches={json.dumps(launches)}, "
        f"all through the indexed entries")
    spy.hold("quickstart")
    return launches, {"bitmap_join_many":
                      calls.recorders["bitmap_join_many"]}


def phase_distributed(dev):
    """Phase 23: ``examples/torch_distributed_mining.py``'s ``run`` on the
    card at the script's settings (mushroom, 2,500 transactions, eight
    shards: logical shards on a host with fewer cards): ``mine(mesh=)``
    at bucket and depth-first grain, then ``mine_distributed`` under
    round_robin and clustered, each equal to ``mine_serial``, each timed
    and counted alone; ``ShardSpy`` attributes every launch to a shard
    (every shard must launch the dense kernel), and each (kernel,
    shard)'s first call is held against its plain version. Returns the
    launches."""
    import torch_distributed_mining as tdm

    def label(name, args, kw):
        return (f"mine_distributed/{kw['policy']}"
                if name == "mine_distributed"
                else f"mesh/{kw['granularity']}")

    log("distributed: examples/torch_distributed_mining.py run()")
    calls = CallSpy([(tdm, "mine"), (tdm, "mine_distributed")], label)
    with calls:
        done, wall, launches, spy, shards = mesh_spied(
            lambda: tdm.run(dev, out=log))
    n = len(done["granularities"]["bucket"][1].per_device)
    for label, run_wall, got, (res, met) in calls.calls:
        if res != done["serial"]:
            raise SystemExit(f"distributed[{label}]: supports differ from "
                             f"mine_serial")
        if isinstance(met, dict):
            line = (f"rows_touched={met['rows_touched']} "
                    f"candidates={met['candidates']} d2d_bytes="
                    f"{met['d2d_bytes']} migrations={met['migrations']} "
                    f"n_devices={met['n_devices']}")
            per = met["per_device"]
        else:
            line = (f"rows_touched={met.rows_touched} d2d_bytes="
                    f"{met.d2d_bytes} migrations={met.migrations} "
                    f"cache_misses={met.cache_misses} "
                    f"candidates={met.candidates} n_devices={met.n_devices}")
            per = met.per_device
        if len(per) != n or n != tdm.N_SHARDS:
            raise SystemExit(f"distributed[{label}]: {len(per)} shards")
        occ = "/".join(f"{d['batch_occupancy']:.2f}" for d in per)
        flushes = "/".join(str(d["flushes"]) for d in per)
        log(f"distributed mine[{label}, max_k=4]: wall_s={run_wall:.3f} "
            f"{line} dev_occupancy={occ} flushes={flushes} "
            f"launches={json.dumps(got)} supports==mine_serial ok")
    per_shard = shards.check("distributed", n)
    spy.check_route("distributed", launches, 0, indexed=True)
    log(f"distributed: {len(done['serial'])} itemsets over {n} shards, "
        f"every run == mine_serial in {wall:.1f} s; launches="
        f"{json.dumps(launches)}, per shard mirror {per_shard}")
    spy.hold("distributed")
    shards.hold("distributed")
    return launches


def phase_streaming_patterns(dev):
    """Phase 24: ``examples/torch_streaming_patterns.py``'s ``run`` on
    the card at the script's settings (retail: 10,000 transactions
    mined, then four ingests of 500, each with a top-3 query and a
    refresh, max_k=5, under the fraction threshold 1.2%, so the border
    moves both ways): every generation equal to ``mine_serial`` at its
    own threshold, the dense kernel launched with tuple prefixes (the
    delta refreshes), the first call of each entry and the first
    tuple-prefix call held against their plain versions; the initial
    refresh's launches are recorded for phase 9's row at the retail
    shape. Returns (launches, recorders)."""
    import torch_streaming_patterns as tsp
    from repro_torch.core import streaming as ts
    from repro_torch.core.fpm import mine_serial
    from repro_torch.core.tidlist import pack_database
    from repro_torch.data.transactions import load
    order = itertools.count(1)
    log("streaming-patterns: examples/torch_streaming_patterns.py run()")
    calls = CallSpy([(ts.StreamingMiner, "refresh")],
                    lambda *_: f"refresh {next(order)}", record="refresh 1")
    with EntrySpy() as spy, calls:
        reset_launches()
        t0 = time.perf_counter()
        done = tsp.run(dev, out=log)
        wall = time.perf_counter() - t0
        launches = counted_launches()
    db, prof = load("retail", seed=0)
    sparse = 0
    for (rep, supports), (label, run_wall, got, _) in zip(
            done["generations"], calls.calls):
        want = mine_serial(pack_database(db[:rep.n_transactions],
                                         prof.n_items),
                           rep.min_support, max_k=5)
        if supports != want:
            missing = len(want.keys() - supports.keys())
            raise SystemExit(f"streaming-patterns: generation "
                             f"{rep.generation} differs from mine_serial "
                             f"at min_support {rep.min_support} ({missing} "
                             f"itemsets missing)")
        met = rep.metrics
        sparse += met.sparse_sweeps
        log(f"streaming-patterns gen {rep.generation}: wall_s={run_wall:.3f}"
            f" |D|={rep.n_transactions} min_support={rep.min_support} "
            f"frequent={rep.frequent} born={rep.born} died={rep.died} "
            f"reused={rep.reused} delta={rep.swept_delta} "
            f"full={rep.swept_full} rows={rep.rows_touched} "
            f"flushes={met.flushes} occupancy={met.batch_occupancy:.2f} "
            f"sparse_sweeps={met.sparse_sweeps} dense_sweeps="
            f"{met.dense_sweeps} launches={json.dumps(got)} "
            f"== mine_serial ok")
    if not any(rep.died for rep, _ in done["generations"]):
        raise SystemExit("streaming-patterns: no generation lost an "
                         "itemset; the border did not move both ways")
    spy.check_route("streaming-patterns", launches, sparse, indexed=True)
    tuples = sum(spy.tuple_shapes.values())
    if not tuples:
        raise SystemExit("streaming-patterns: no tuple-prefix launch")
    payload = [ing.payload_bytes for ing in done["ingests"]]
    log(f"streaming-patterns: {len(done['generations'])} generations == "
        f"mine_serial in {wall:.1f} s; ingests {payload} B; top-3 "
        f"{done['top3'][-1]}; support{done['itemset']} = {done['support']}"
        f"; launches={json.dumps(launches)} (sparse_sweeps={sparse}), "
        f"{tuples} with tuple prefixes; tuple shapes (B', L, E', W_seg): "
        f"{dict(spy.tuple_shapes.most_common(4))}")
    spy.hold("streaming-patterns")
    rec = calls.recorders["gather_intersect_many"]
    if not rec.shapes:
        log("streaming-patterns: the initial refresh made no sparse sweep; "
            "phase 9 has no gather_intersect_many row at the retail shape")
    x = set(done["itemset"])
    if done["support"] != sum(1 for t in db[:rep.n_transactions]
                              if x <= set(t)):
        raise SystemExit("streaming-patterns: support() of the top itemset "
                         "differs from a host count")
    return launches, {"gather_intersect_many": rec}


def phase_profile(dev, bitmaps, counts, min_support, granularity,
                  representation, max_k):
    """A rerun of a mining phase under torch.profiler: how much of its
    wall time the device was busy, and on what."""
    import repro_torch

    def run():
        repro_torch.mine(bitmaps, min_support, device=dev,
                         granularity=granularity, policy="clustered",
                         max_k=max_k, representation=representation,
                         item_counts=counts)
    wall, busy, top = device_profile(run)
    log(f"profile mine[{granularity}, {representation}, max_k={max_k}] "
        f"(profiled rerun): wall_s={wall:.3f} device_busy_s={busy:.4f} "
        f"device_busy_share={busy / wall:.5f}")
    for sec, count, key in top:
        log(f"  device {sec:.4f} s in {count} x {key[:90]}")


def phase_profile_stream(dev, db, n_items, min_support):
    """A rerun of phase 13's two ingest+refresh rounds under
    torch.profiler (the initial refresh runs unprofiled first): how
    much of a refresh's wall the device was busy, and on what."""
    from repro_torch.core import streaming as ts
    sm = ts.StreamingMiner(
        n_items, min_support, initial_db=db[:STREAM_INITIAL], device=dev,
        policy="clustered", n_workers=8, max_k=MAIN_MAX_K,
        granularity="bucket", arena="jax", representation="auto")
    try:
        sm.refresh()

        def run():
            for lo, hi in STREAM_BATCHES:
                sm.ingest(db[lo:hi])
                sm.refresh()
        wall, busy, top = device_profile(run)
    finally:
        sm.close()
    log(f"profile stream[2 x ingest + refresh, bucket, max_k={MAIN_MAX_K}]"
        f" (profiled rerun): wall_s={wall:.3f} device_busy_s={busy:.4f} "
        f"device_busy_share={busy / wall:.5f}")
    for sec, count, key in top:
        log(f"  device {sec:.4f} s in {count} x {key[:90]}")


def work(name, args):
    """(bytes, integer ops) the kernel ``name`` must move and do on these
    inputs, each read or written once. The batched kernels count what
    the real lanes need, whatever implements them: the distinct store
    rows they name, ``n_words`` words each (for gather_intersect_many
    the distinct (row, 32-byte sector) pairs their valid tids touch),
    plus the indices, tids and counts. Pad requests and lanes, tids past
    a request's length and a row's words past ``n_words`` are no work."""
    import torch
    if name == "bitmap_join":
        p, x = args
        e, w = x.shape
        return (w + e * w + e) * 4, 3 * e * w
    if name == "bitmap_join_many":
        # a prefix tuple (pidx [B, L]) is read row by row and ANDed: its
        # rows count as prefix rows, and each row past the first costs
        # one AND per word
        prefix_rows, pidx, ext_rows, eidx, n = args
        tup = pidx if pidx.dim() == 2 else pidx[:, None]
        in_tuple = torch.cumprod((tup >= 0).int(), dim=1).bool()
        real = in_tuple[:, 0]
        live = real[:, None] & (eidx >= 0)
        p_rows = torch.unique(tup[in_tuple])
        e_rows = torch.unique(eidx[live])
        rows = (torch.unique(torch.cat([p_rows, e_rows])).numel()
                if prefix_rows.data_ptr() == ext_rows.data_ptr()
                else p_rows.numel() + e_rows.numel())
        nbytes = (rows * n + pidx.numel() + 2 * eidx.numel()) * 4
        ands = int(in_tuple.sum()) - int(real.sum())
        return nbytes, (3 * int(live.sum()) + ands) * n
    tids, lens, ext_rows, eidx, n = args
    b, s = tids.shape
    valid = (tids >= 0) & (torch.arange(s, device=tids.device)[None, :]
                           < lens[:, None])
    sectors, ops = [], 0
    for i in range(b):
        t = tids[i][valid[i]].long()
        r = eidx[i][eidx[i] >= 0].long()
        ops += 4 * t.numel() * r.numel()
        word = torch.clamp(t >> 5, max=n - 1)
        # the store's base is 512-byte aligned, so a word's sector is
        # its word offset // 8
        sectors.append(torch.unique(
            (r[:, None] * ext_rows.stride(0) + word[None, :]) >> 3))
    n_sectors = torch.unique(torch.cat(sectors)).numel()
    nbytes = n_sectors * 32 + (int(valid.sum()) + b + 2 * eidx.numel()) * 4
    return nbytes, ops


def describe(name, args):
    """The launch shape of ``args`` as text."""
    if name == "bitmap_join":
        return f"E={args[1].shape[0]} W={args[1].shape[1]}"
    b, e = args[3].shape
    s = f" S={args[0].shape[1]}" if name == "gather_intersect_many" else ""
    if name == "bitmap_join_many" and args[1].dim() == 2:
        s = f" L={args[1].shape[1]}"
    live = int((args[3] >= 0).sum())
    return (f"B={b} E={e}{s} ({live} real lanes) n_words={args[4]} "
            f"store [{args[2].shape[0]}, {args[2].stride(0)}]")


def parent_design(name, args):
    """The parent commit's sweep step on the same inputs, as two
    callables (the gathered copy alone; copy plus kernel) and the check
    of its counts: pad the batch to the reference's shape (pad requests
    and lanes name row 0), gather the [B', E', W'] extension rows (and,
    dense, the [B', W'] prefixes) out of the store with ``index_select``
    at the store's full width, and run the gathered-form call on them."""
    import torch
    from repro_torch.core.tidlist import pow2
    from repro_torch.kernels.bitmap_join import ops as bj
    from repro_torch.kernels.gather_intersect import ops as gi
    store, eidx = args[2], args[3]
    b, e = eidx.shape
    bp, ep, w = pow2(b), pow2(e, lo=64), store.shape[1]
    ei = torch.zeros((bp, ep), dtype=torch.int64, device=store.device)
    ei[:b, :e] = eidx.clamp(min=0)
    ei = ei.view(-1)
    if name == "bitmap_join_many":
        pi = torch.zeros(bp, dtype=torch.int64, device=store.device)
        pi[:b] = args[1].clamp(min=0)

        def copy():
            return (store.index_select(0, pi),
                    store.index_select(0, ei).view(bp, ep, w))

        def step():
            return bj.bitmap_join_many(*copy())
    else:
        tids, lens = args[0], args[1]
        s = tids.shape[1]
        tp = torch.full((bp, pow2(s, lo=64)), -1, dtype=torch.int32,
                        device=store.device)
        tp[:b, :s] = torch.where(
            torch.arange(s, device=store.device)[None, :] < lens[:, None],
            tids, -1)

        def copy():
            return store.index_select(0, ei).view(bp, ep, w)

        def step():
            return gi.gather_intersect_many(tp, copy())
    return copy, step


def measure(name, kernel, plain, args, floor_ms=None):
    """Time one kernel against its plain version and its bound on
    ``args``, and for a batched kernel the parent design on the same
    inputs; fails if any of them disagree."""
    import torch
    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err:
        raise SystemExit(f"{name} disagrees with its plain version at "
                         f"{describe(name, args)}")
    # "ms" is the L2-warm time (the mirror is 10-20 MB and stays in the
    # 50 MB L2 between flushes), "ms_cold" the time from HBM, the one the
    # bytes bound speaks of
    ms, host_ms = time_ms(lambda: kernel(*args))
    ms_cold, _ = time_ms(lambda: kernel(*args), cold=True)
    plain_ms, _ = time_ms(lambda: plain(*args), iters=3, warmup=1)
    nbytes, ops = work(name, args)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    m = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "library_ms": None, "ms_cold": ms_cold, "host_ms": host_ms,
         "bytes": nbytes, "ops": ops}
    if name == "bitmap_join" or args[1].dim() == 2:
        # the parent commit had no tuple-prefix sweep to compare with
        return m
    copy, step = parent_design(name, args)
    old = step()
    b, e = args[3].shape
    if not torch.equal(torch.where(args[3] >= 0, old[:b, :e], 0), got):
        raise SystemExit(f"the parent design disagrees with {name} at "
                         f"{describe(name, args)}")
    m["parent_copy_ms"], _ = time_ms(copy)
    m["parent_design_ms"], m["parent_design_host_ms"] = time_ms(step)
    m["parent_design_ms_cold"], _ = time_ms(step, cold=True)
    m["launch_floor_ms"] = floor_ms
    return m


def log_time(name, where, shape, m):
    log(f"time {name} at {shape} ({where}): kernel {m['ms']:.4f} ms on "
        f"the device, L2-warm ({m['ms_cold']:.4f} ms from HBM; "
        f"{m['host_ms']:.4f} ms host per launch), plain "
        f"{m['plain_ms']:.4f} ms, bound {m['bound_ms']:.5f} ms "
        f"({m['bound_by']}: {m['bytes']} B, {m['ops']} ops)")
    if "parent_design_ms" in m:
        log(f"  parent design (gathered copy + kernel) "
            f"{m['parent_design_ms']:.4f} ms L2-warm "
            f"({m['parent_design_ms_cold']:.4f} ms from HBM; "
            f"{m['parent_design_host_ms']:.4f} ms host), of which the "
            f"copy {m['parent_copy_ms']:.4f} ms; launch floor "
            f"{m['launch_floor_ms']:.4f} ms")


def report(recorder_sets, entry_inputs, launches, worst, stream_spy):
    """The kernels line: each batched kernel timed through its indexed
    entry at its most frequent batch shape in each recorded run of
    ``recorder_sets`` ((phase, {kernel: Recorder}); phase 3's first, then
    phase 5's, phase 22's chess bucket mine for ``bitmap_join_many`` and
    phase 24's retail initial refresh for ``gather_intersect_many``;
    ``bitmap_join_many`` also at phase 13's most frequent tuple-prefix
    shape), the single-prefix kernel at the entry point's shapes, all on
    inputs captured from those runs. ``launches`` maps each kernel to
    its launches per phase."""
    import torch
    from repro_torch.kernels.bitmap_join import ops as bj
    from repro_torch.kernels.bitmap_join.ref import (
        bitmap_join_many_rows_ref, bitmap_join_ref)
    from repro_torch.kernels.gather_intersect import ops as gi
    from repro_torch.kernels.gather_intersect.ref import (
        gather_intersect_many_rows_ref)
    # an empty kernel between the same event pairs: the floor under
    # every device time below
    floor_ms, floor_host_ms = time_ms(lambda: torch.cuda._sleep(0))
    log(f"time launch floor (torch.cuda._sleep(0)): {floor_ms:.4f} ms on "
        f"the device, {floor_host_ms:.4f} ms host")
    rows = []
    specs = [
        ("bitmap_join_many", bj.bitmap_join_many_rows,
         bitmap_join_many_rows_ref,
         "src/repro_torch/kernels/csrc/bitmap_join_many.cu",
         "src/repro/kernels/bitmap_join/kernel.py:116"),
        ("gather_intersect_many", gi.gather_intersect_many_rows,
         gather_intersect_many_rows_ref,
         "src/repro_torch/kernels/csrc/gather_intersect_many.cu",
         "src/repro/kernels/gather_intersect/kernel.py:74"),
        ("bitmap_join", bj.bitmap_join, bitmap_join_ref,
         "src/repro_torch/kernels/csrc/bitmap_join.cu",
         "src/repro/kernels/bitmap_join/kernel.py:56"),
    ]
    for name, kernel, plain, source, replaces in specs:
        # (label, arguments, where they came from); the first case gives
        # the line's numbers: the phase-3 shape, or the kernels-bench one
        if name == "bitmap_join":
            cases = [(k, args, f"entry point, {k}")
                     for k, args in entry_inputs.items()]
        else:
            cases = []
            for phase, recs in recorder_sets:
                rec = recs.get(name)
                if rec is None or not rec.shapes:
                    continue
                axes = "B', S', E'" if rec.sparse else "B', E'"
                log(f"  {name} {phase} batch shapes (padded {axes}): "
                    f"{dict(rec.shapes.most_common(8))}")
                key = rec.main_shape()
                cases.append((phase, rec.case(key),
                              f"{rec.shapes[key]} of "
                              f"{sum(rec.shapes.values())} {phase}-phase "
                              f"calls at padded shape {key}"))
            if name == "bitmap_join_many":
                shapes = stream_spy.tuple_shapes
                key = next(k for k, _ in shapes.most_common()
                           if k in stream_spy.tuple_inputs)
                cases.append(("stream", stream_spy.tuple_inputs[key],
                              f"{shapes[key]} of {sum(shapes.values())} "
                              f"phase-13 tuple-prefix calls at (B', L, "
                              f"E', W_seg) {key}"))
        shapes = {}
        for label, args, where in cases:
            m = measure(name, kernel, plain, args, floor_ms)
            log_time(name, where, describe(name, args), m)
            shapes[label] = {"shape": describe(name, args), "where": where,
                             **m}
        m = shapes[cases[0][0]]
        per_phase = launches[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(per_phase.values()),
            "max_abs_err": max(worst[name], m["max_abs_err"]),
            **{k: m[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "ms_cold", "host_ms")},
            "launches_by_phase": per_phase, "shapes": shapes,
        })
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.core import fpm
    from repro_torch.core.join_backend import (bitmap_join_many_rows,
                                               gather_intersect_many_rows)
    from repro_torch.core.tidlist import pack_database
    from repro_torch.data.transactions import load, min_support_count
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    t_last = [t_start]

    def clock(phase):
        now = time.perf_counter()
        log(f"clock: {phase} {now - t_last[0]:.1f} s, "
            f"{now - t_start:.1f} s in all")
        t_last[0] = now

    phase_build()
    worst = phase_parity(dev)
    clock("build+parity")

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
    clock("data+serial")

    def recs():
        return {"bitmap_join_many": Recorder(bitmap_join_many_rows, False),
                "gather_intersect_many": Recorder(gather_intersect_many_rows,
                                                  True)}

    launches = {"bitmap_join_many": {}, "gather_intersect_many": {},
                "bitmap_join": {}}

    def note(phase, got):
        for name, n in got.items():
            launches[name][phase] = n

    recorders = recs()
    got, main_met = phase_mine(dev, bitmaps, counts, min_support, "bucket",
                               "auto", MAIN_MAX_K, serial, recorders)
    if min(got.values()) == 0:
        raise SystemExit(f"a kernel never launched on the main path: "
                         f"{got}")
    note("bucket", got)
    clock("main")
    got, bitmap_met = phase_mine(dev, bitmaps, counts, min_support,
                                 "bucket", "bitmap", BITMAP_MAX_K, serial)
    if got["bitmap_join_many"] == 0 or got["gather_intersect_many"] != 0:
        raise SystemExit(f"representation='bitmap' must launch only "
                         f"bitmap_join_many: {got}")
    note("bucket-bitmap", got)
    clock("bitmap")
    df_recorders = recs()
    for granularity in ("depth-first", "auto"):
        got, met = phase_mine(
            dev, bitmaps, counts, min_support, granularity, "auto",
            MAIN_MAX_K, serial,
            df_recorders if granularity == "depth-first" else None)
        if got["bitmap_join_many"] == 0 or (
                met.sparse_sweeps > 0 and got["gather_intersect_many"] == 0):
            raise SystemExit(f"granularity={granularity!r}: a kernel of "
                             f"its sweeps never launched: {got}, "
                             f"sparse_sweeps={met.sparse_sweeps}")
        note(granularity, got)
        clock(granularity)
    n, entry_inputs = phase_entry(dev, bitmaps, counts)
    note("entry", {"bitmap_join": n})
    clock("entry")
    note("trace", phase_trace(dev, bitmaps, counts, min_support, serial,
                              main_met.wall_s))
    clock("trace")
    for backing, got in phase_residency(dev, bitmaps, counts, min_support,
                                        serial).items():
        note(f"residency-{backing}", got)
    clock("residency")
    note("launcher", phase_launcher())
    clock("launcher")
    got, sm, stream_spy = phase_stream(dev, db, prof.n_items, bitmaps,
                                       min_support, serial, "bucket",
                                       MAIN_MAX_K, "stream")
    note("stream", got)
    try:
        note("serve", phase_serve(sm, db, bitmaps, serial))
    finally:
        sm.close()
    clock("stream+serve")
    got, sm, _ = phase_stream(dev, db, prof.n_items, bitmaps, min_support,
                              serial, "depth-first", BITMAP_MAX_K,
                              "stream-depth-first")
    sm.close()
    note("stream-depth-first", got)
    clock("stream-depth-first")
    note("launcher-stream", phase_launcher_stream())
    clock("launcher-stream")
    for column, got in phase_cluster(dev, bitmaps, counts, min_support,
                                     serial, bitmap_met).items():
        note(column, got)
    clock("cluster")
    note("cluster-stream", phase_cluster_stream(dev, db, prof.n_items,
                                                min_support, serial))
    clock("cluster-stream")
    note("tenants", phase_tenants(dev, db, prof.n_items, min_support))
    clock("tenants")
    note("hosts", phase_hosts())
    note("hosts-loopback", phase_hosts_loopback(dev))
    clock("hosts")
    for column, got in phase_mesh(dev, bitmaps, counts, min_support, serial,
                                  main_met, bitmap_met).items():
        note(column, got)
    clock("mesh")
    for column, got in phase_mesh_stream(dev, db, prof.n_items,
                                         min_support, serial).items():
        note(column, got)
    clock("mesh-stream+mesh-tenants")
    note("launcher-mesh", phase_launcher_mesh())
    clock("launcher-mesh")
    got, quick_recs = phase_quickstart(dev)
    note("quickstart", got)
    clock("quickstart")
    note("distributed", phase_distributed(dev))
    clock("distributed")
    got, stream_recs = phase_streaming_patterns(dev)
    note("streaming-patterns", got)
    clock("streaming-patterns")

    for granularity, representation, max_k in (
            ("bucket", "auto", MAIN_MAX_K),
            ("bucket", "bitmap", BITMAP_MAX_K),
            ("depth-first", "auto", MAIN_MAX_K),
            ("auto", "auto", MAIN_MAX_K)):
        phase_profile(dev, bitmaps, counts, min_support, granularity,
                      representation, max_k)
    phase_profile_stream(dev, db, prof.n_items, min_support)
    clock("profile")
    rows = report([("bucket", recorders), ("depth-first", df_recorders),
                   ("quickstart chess bucket", quick_recs),
                   ("streaming-patterns retail initial refresh",
                    stream_recs)],
                  entry_inputs, launches, worst, stream_spy)
    clock("report")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
