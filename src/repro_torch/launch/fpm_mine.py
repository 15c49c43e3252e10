"""FPM mining launcher of the PyTorch/CUDA port — the paper's experiment
end to end: a host ``mine_serial`` reference, then one mine per
scheduling policy through ``repro_torch.mine``, each checked equal to
the reference. With ``--stream N`` it replays the dataset's tail as N
ingest+refresh rounds through a ``StreamingMiner`` instead (the final
generation checked equal to the reference), and ``--serve M`` then
serves M queries of each kind through a ``PatternServer``.

Example (clustered against Cilk-style scheduling on the card):
    PYTHONPATH=src python -m repro_torch.launch.fpm_mine --dataset t10i4 \
        --workers 8 --policies cilk clustered --max-k 8 --trace-summary

Example (streaming refresh and query serving on the card):
    PYTHONPATH=src python -m repro_torch.launch.fpm_mine --dataset t10i4 \
        --stream 2 --serve 64 --max-k 8

Example (two rank processes, each mining its word slice on the one card,
reducing every flush through a TCPStore this process hosts):
    PYTHONPATH=src python -m repro_torch.launch.fpm_mine --dataset t10i4 \
        --hosts 2 --max-k 8

Example (two device shards: the first two CUDA devices, or two logical
shards on the one card when the host has fewer):
    PYTHONPATH=src python -m repro_torch.launch.fpm_mine --dataset t10i4 \
        --mesh 2 --policies clustered --max-k 8

The mines run on the CUDA card unless ``--device cpu`` is given; without
a card and without ``--device`` the launcher raises ``RuntimeError``
before it builds any data.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.buckets import REPRESENTATIONS
from repro_torch.core.fpm import (GRANULARITIES, mesh_over_devices, mine,
                                  mine_serial)
from repro_torch.core.streaming import PatternServer, StreamingMiner
from repro_torch.core.tidlist import (ARENA_BACKINGS, pack_database,
                                      resolve_device)
from repro_torch.data.transactions import PROFILES, load
from repro_torch.obs import Tracer, summary_table, write_chrome_trace


def _finish_trace(args, tracer, wall_s: float) -> None:
    """Flush the run's tracer: Chrome-trace JSON for ``--trace`` (one
    lane per worker/dispatcher, loadable at https://ui.perfetto.dev)
    and the terminal time-in-state table for ``--trace-summary``."""
    if tracer is None:
        return
    if args.trace:
        write_chrome_trace(tracer, args.trace)
        print(f"trace: wrote {args.trace} "
              f"({len(tracer.events())} events) — open in "
              f"https://ui.perfetto.dev")
    if args.trace_summary:
        print(summary_table(tracer, wall_s))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.fpm_mine")
    ap.add_argument("--dataset", default="chess", choices=list(PROFILES))
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--policies", nargs="+",
                    default=["cilk", "clustered"])
    ap.add_argument("--granularity", default="bucket",
                    choices=list(GRANULARITIES),
                    help="task grain: bucket (level-sync sweep), "
                         "candidate (scalar joins), depth-first "
                         "(barrier-free class recursion) or auto")
    ap.add_argument("--representation", default="auto",
                    choices=list(REPRESENTATIONS),
                    help="row representation: bitmap (word-columns "
                         "only), sparse (force tid-list/diffset rows), "
                         "auto (density-driven per-subtree choice)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "numpy", "torch"],
                    help="join backend: auto (= torch, the kernel "
                         "backend) or numpy (the host backend)")
    ap.add_argument("--device", default=None,
                    help="where the arena mirror lives and the kernels "
                         "run: the CUDA card by default, 'cpu' for the "
                         "kernels' plain versions on the host")
    ap.add_argument("--arena", default="auto", choices=list(ARENA_BACKINGS),
                    help="bitmap arena backing: auto (lazy device "
                         "mirror), jax (eager upload to the device), "
                         "numpy (host-only; the kernel backend re-uploads "
                         "per batch — the transfer-bound baseline)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run the engine over N device shards (sharded "
                         "arena, one dispatcher per shard, shard-affine "
                         "workers): the first N CUDA devices when the "
                         "host has them, N logical shards on --device "
                         "otherwise; 0 = shared-memory run")
    ap.add_argument("--max-batch", type=int, default=32,
                    help="sweep dispatcher: max requests per batched "
                         "kernel launch")
    ap.add_argument("--flush-us", type=float, default=200.0,
                    help="sweep dispatcher: µs to wait for straggler "
                         "requests before flushing a partial batch")
    ap.add_argument("--support", type=float, default=None,
                    help="override the profile's min-support fraction")
    ap.add_argument("--max-k", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a time-resolved trace of the run "
                         "(task/flush/steal spans, one lane per "
                         "worker) and write Chrome trace-event JSON "
                         "loadable in Perfetto")
    ap.add_argument("--trace-summary", action="store_true",
                    help="print the per-worker time-in-state table "
                         "(sweep/eval/idle/steal) after the run; "
                         "implies tracing even without --trace")
    ap.add_argument("--stream", type=int, default=0, metavar="N",
                    help="streaming mode: hold back the tail of the "
                         "dataset and replay it as N ingest+refresh "
                         "rounds through a StreamingMiner (prints "
                         "per-round border/reuse stats; the final "
                         "generation is verified against the serial "
                         "batch miner)")
    ap.add_argument("--stream-frac", type=float, default=0.1,
                    help="fraction of the dataset replayed as the "
                         "ingest stream (with --stream)")
    ap.add_argument("--serve", type=int, default=0, metavar="N",
                    help="after the stream replay, serve N queries of "
                         "each kind (known-hit, batched unknown-itemset "
                         "sweep, top-k) through the PatternServer and "
                         "print per-kind p50/p95/p99 (with --stream)")
    ap.add_argument("--hosts", type=int, default=0, metavar="N",
                    help="multi-host mode: spawn N rank processes, each "
                         "owning a word slice of the transaction axis on "
                         "--device, with two-phase support counting "
                         "(local partial counts + per-flush reduction "
                         "through a TCPStore this process hosts). 0 = "
                         "single process")
    # child-rank plumbing for --hosts (set by the parent, not by hand)
    ap.add_argument("--_rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--_nprocs", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--_coordinator", default=None,
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _spawn_hosts(args) -> None:
    """Parent of a ``--hosts N`` run: host a TCPStore on a free local
    port, spawn one rank process per host on ``--device``, then print
    rank 0's report and every other rank's lines (prefixed with its
    rank), and fail on the first rank that exited non-zero."""
    from torch.distributed import TCPStore
    if args.stream:
        raise SystemExit("--hosts and --stream are mutually exclusive "
                         "(use StreamingMiner(hosts=N) for multi-host "
                         "streaming)")
    store = TCPStore("127.0.0.1", 0, is_master=True,
                     wait_for_workers=False)
    coord = f"127.0.0.1:{store.port}"
    base = [sys.executable, "-m", "repro_torch.launch.fpm_mine",
            "--dataset", args.dataset, "--workers", str(args.workers),
            "--policies", args.policies[0],
            "--granularity", args.granularity, "--backend", args.backend,
            "--max-batch", str(args.max_batch),
            "--flush-us", str(args.flush_us), "--max-k", str(args.max_k),
            "--seed", str(args.seed), "--_coordinator", coord,
            "--_nprocs", str(args.hosts)]
    if args.support is not None:
        base += ["--support", str(args.support)]
    if args.device is not None:
        base += ["--device", args.device]
    # the ranks import this package from where this process found it
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    print(f"hosts: spawning {args.hosts} ranks @ {coord} (TCPStore, "
          f"device={args.device or 'cuda'})", flush=True)
    procs = [subprocess.Popen(base + ["--_rank", str(r)], env=env,
                              stdout=subprocess.PIPE, text=True)
             for r in range(args.hosts)]
    outs = [p.communicate()[0] for p in procs]
    for r, out in enumerate(outs):
        for line in out.splitlines():
            print(line if r == 0 else f"rank {r}: {line}")
    for r, p in enumerate(procs):
        if p.returncode:
            raise SystemExit(f"rank {r} exited with {p.returncode}")
    del store


def _rank(args, bitmaps, ms, device) -> None:
    """One rank of a ``--hosts`` run: mine this rank's word slice with
    the store transport and print its kernel launches; rank 0 also
    checks the result against ``mine_serial`` and prints the result
    line."""
    from repro_torch.core.cluster import mine_distributed_process
    from repro_torch.kernels.bitmap_join import ops as bj
    from repro_torch.kernels.gather_intersect import ops as gi
    res, met = mine_distributed_process(
        bitmaps, ms, rank=args._rank, n_procs=args._nprocs,
        coordinator=args._coordinator, device=device, serve_store=False,
        policy=args.policies[0], n_workers=args.workers, max_k=args.max_k,
        granularity=args.granularity, backend=args.backend,
        max_batch=args.max_batch, flush_us=args.flush_us)
    print("launches: " + json.dumps({"bitmap_join_many": bj.launches,
                                     "gather_intersect_many": gi.launches}))
    if args._rank != 0:
        return
    if res != mine_serial(bitmaps, ms, max_k=args.max_k):
        raise SystemExit("hosts result differs from mine_serial")
    s = met.scheduler
    print(f"{args.policies[0]:10s} hosts={met.n_hosts} "
          f"wall={met.wall_s:6.2f}s frequent={len(res)} "
          f"steals={int(s.get('steals', 0)):6d} "
          f"net={met.net_bytes}B steal_net={met.steal_net}B "
          f"flushes={met.flushes} batch_occ={met.batch_occupancy:4.2f}; "
          f"equals mine_serial")


def _stream(args, db, n_items, ms, ref, device, mesh, tracer) -> None:
    """``--stream``: mine the head of the dataset, replay its tail as
    ``args.stream`` ingest+refresh rounds, check the final generation
    against ``mine_serial``, then (``--serve``) time the queries."""
    n_stream = max(args.stream, int(args.stream_frac * len(db)))
    init, tail = db[:-n_stream], db[-n_stream:]
    per = max(1, len(tail) // args.stream)
    sm = StreamingMiner(n_items, ms, initial_db=init, device=device,
                        policy=args.policies[0], n_workers=args.workers,
                        max_k=args.max_k, granularity=args.granularity,
                        backend=args.backend, arena=args.arena,
                        max_batch=args.max_batch, flush_us=args.flush_us,
                        mesh=mesh, representation=args.representation,
                        tracer=tracer)
    try:
        t_stream0 = time.perf_counter()
        rep = sm.refresh()
        print(f"stream gen1: |D|={rep.n_transactions} "
              f"frequent={rep.frequent} wall={rep.wall_s:.2f}s "
              f"rows={rep.rows_touched}")
        for r in range(args.stream):
            batch = (tail[r * per:] if r == args.stream - 1
                     else tail[r * per:(r + 1) * per])
            if not batch:
                break
            ing = sm.ingest(batch)
            rep = sm.refresh()
            print(f"stream gen{rep.generation}: +{ing.n_transactions}tx "
                  f"(seg {ing.segment}, {ing.payload_bytes}B, "
                  f"h2d={ing.h2d_bytes}B) wall={rep.wall_s:.2f}s "
                  f"rows={rep.rows_touched} reused={rep.reused} "
                  f"delta={rep.swept_delta} full={rep.swept_full} "
                  f"born={rep.born} died={rep.died} "
                  f"compacted={rep.compacted_segments}"
                  f"/{rep.compaction_bytes}B", flush=True)
        if dict(sm.snapshot.supports) != ref:
            raise SystemExit("stream result differs from mine_serial")
        srv = PatternServer(sm)
        top = srv.top_k((), 5)
        print(f"stream final == serial; top-5: {top}")
        if args.serve:
            _serve(args, srv, sm, top, n_items)
        _finish_trace(args, tracer, time.perf_counter() - t_stream0)
    finally:
        sm.close()


def _serve(args, srv, sm, top, n_items: int) -> None:
    """``--serve``: ``args.serve`` known hits and top-k queries, then
    ``args.serve`` batches of 8 never-counted itemsets (size max_k + 1),
    each kind's per-query latency percentiles."""
    hot = [x for x, _ in top] or [(0,)]
    fresh = itertools.chain.from_iterable(
        itertools.combinations(range(n_items), k)
        for k in range(args.max_k + 1, n_items + 1))
    lat = {"hit": [], "sweep": [], "top_k": []}
    for i in range(args.serve):
        x = hot[i % len(hot)]
        t0 = time.perf_counter_ns()
        srv.support(x)
        lat["hit"].append((time.perf_counter_ns() - t0) / 1e3)
        t0 = time.perf_counter_ns()
        srv.top_k(x[:1], 5)
        lat["top_k"].append((time.perf_counter_ns() - t0) / 1e3)
    batch = 8
    for _ in range(args.serve):
        xs = list(itertools.islice(fresh, batch))
        t0 = time.perf_counter_ns()
        srv.support_many(xs)
        lat["sweep"].append((time.perf_counter_ns() - t0) / 1e3 / len(xs))
    for kind, us in lat.items():
        a = np.asarray(us)
        print(f"serve {kind:6s}: n={len(us):4d} "
              f"p50={np.percentile(a, 50):8.1f}us "
              f"p95={np.percentile(a, 95):8.1f}us "
              f"p99={np.percentile(a, 99):8.1f}us")
    print(f"serve stats: {srv.merged_stats()} "
          f"query_sweeps={sm.query_sweeps} "
          f"query_sweep_bytes={sm.query_sweep_bytes}")
    print(f"serve recorder: {srv.latency_percentiles()}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.hosts >= 2 and args.mesh:
        raise ValueError("hosts= and mesh= are mutually exclusive (a host "
                         "owns its whole slice)")
    # as in the reference launcher, --hosts 1 is one process
    if args.hosts >= 2 and args._rank is None:
        return _spawn_hosts(args)

    db, prof = load(args.dataset, args.seed)
    n_items = (prof.n_dense_items if prof.kind == "dense"
               else prof.n_items)
    bitmaps, item_counts = pack_database(db, n_items, return_counts=True)
    frac = args.support if args.support is not None else prof.support
    ms = max(1, int(frac * len(db)))
    print(f"dataset=synth:{args.dataset} |D|={len(db)} items={n_items} "
          f"min_support={ms} ({frac:.4f}) device={device}")
    if args._rank is not None:
        _rank(args, bitmaps, ms, device)
        return

    mesh = mesh_over_devices(args.mesh)
    if mesh is not None:
        print(f"mesh: {args.mesh} device shards "
              f"({'logical' if isinstance(mesh, int) else 'cuda devices'})")

    t0 = time.time()
    ref = mine_serial(bitmaps, ms, max_k=args.max_k)
    t_serial = time.time() - t0
    print(f"serial: {len(ref)} frequent itemsets in {t_serial:.2f}s")

    tracer = (Tracer() if (args.trace or args.trace_summary)
              else None)
    if args.stream:
        _stream(args, db, n_items, ms, ref, device, mesh, tracer)
        return
    traced_wall = 0.0
    for policy in args.policies:
        res, met = mine(bitmaps, ms, device=device, policy=policy,
                        n_workers=args.workers, max_k=args.max_k,
                        granularity=args.granularity,
                        backend=args.backend, arena=args.arena,
                        max_batch=args.max_batch, flush_us=args.flush_us,
                        mesh=mesh, representation=args.representation,
                        item_counts=item_counts, trace=tracer)
        traced_wall += met.wall_s
        if res != ref:
            raise SystemExit(f"{policy} result differs from mine_serial")
        s = met.scheduler
        line = (f"{policy:10s} wall={met.wall_s:6.2f}s "
                f"speedup={t_serial / met.wall_s:5.2f}x "
                f"cache_hit={met.cache_hit_rate:5.1%} "
                f"steals={int(s['steals']):6d} "
                f"tasks/steal={s['tasks_per_steal']:5.2f} "
                f"bucket_switches={int(s['bucket_switches']):5d} "
                f"frequent={len(res)}")
        if met.flushes:
            line += (f" batch_occ={met.batch_occupancy:4.2f} "
                     f"flushes={met.flushes} h2d={met.h2d_bytes}B")
        if met.n_devices > 1:
            occ = "/".join(f"{d['batch_occupancy']:.2f}"
                           for d in met.per_device)
            line += (f" d2d={met.d2d_bytes}B migrations={met.migrations} "
                     f"dev_occ={occ}")
        if args.granularity == "depth-first":
            line += (f" peak_retained={met.peak_retained_bitmaps}"
                     f" ({met.peak_bytes_retained} B)")
        if met.sparse_sweeps or met.sparse_rows:
            line += (f"\n{'':10s} rep[{met.representation}]: "
                     f"sweeps dense={met.dense_sweeps} "
                     f"sparse={met.sparse_sweeps} "
                     f"sparse_bytes={met.sparse_bytes_swept}B "
                     f"rows={met.sparse_rows} "
                     f"picks={met.rep_picks} "
                     f"densify={met.densify_ops}"
                     f"/{met.densify_bytes}B "
                     f"sparsify={met.sparsify_ops}"
                     f"/{met.sparsify_bytes}B")
        print(line, flush=True)
    _finish_trace(args, tracer, traced_wall)


if __name__ == "__main__":
    main()
