"""Quickstart of the PyTorch/CUDA port: the paper's system on the card.

1. Generate a transaction database (the synthetic 'chess' profile).
2. Mine it with the Cilk-style policy, then the clustered policy, at
   candidate granularity (one scalar join per task, the paper's §2
   setting) and show the locality metrics that explain the difference
   (the Fig. 1 + Table 1 story).
3. Re-mine at bucket granularity: one task per (k-1)-prefix, the prefix
   intersection computed once, all extensions swept in one batched
   launch of the CUDA ``bitmap_join_many`` kernel on the arena's device
   mirror.
4. Re-mine depth-first: barrier-free equivalence-class recursion where
   each task spawns its child classes and hands each child its already-
   intersected prefix row, so no prefix is recomputed (zero cache
   misses).

Run on the card:  PYTHONPATH=src python examples/torch_quickstart.py
      (optionally: --backend numpy --arena jax --max-batch 16
       --flush-us 500 --mesh 2)
On the host:      PYTHONPATH=src python examples/torch_quickstart.py \
                      --device cpu
Without a CUDA device and without ``--device cpu`` it raises
``RuntimeError``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.fpm import mesh_over_devices, mine, mine_serial  # noqa: E402
from repro_torch.core.tidlist import (ARENA_BACKINGS, pack_database,  # noqa: E402
                                      resolve_device)
from repro_torch.data.transactions import load  # noqa: E402

POLICIES = ("cilk", "clustered")
GRANULARITIES = ("candidate", "bucket", "depth-first")


def run(device="cuda", *, backend="auto", arena="auto", max_batch=32,
        flush_us=200.0, mesh=None, n_transactions=None, max_k=4,
        n_workers=4, out=print):
    """The quickstart's mines on ``device``: the serial reference, each
    policy at candidate grain, then each granularity under the clustered
    policy, every result checked equal to the reference. ``mesh`` is
    what ``mine(mesh=)`` takes; ``n_transactions`` keeps the first that
    many transactions (None: all). Returns the supports and metrics of
    every mine: ``{"min_support", "serial", "policies": {policy: (res,
    met)}, "granularities": {granularity: (res, met)}}``."""
    dev = resolve_device(device)
    knobs = dict(device=dev, backend=backend, arena=arena,
                 max_batch=max_batch, flush_us=flush_us, mesh=mesh)
    db, prof = load("chess", seed=0)
    db = db[:n_transactions]
    bitmaps = pack_database(db, prof.n_dense_items)
    min_support = int(prof.support * len(db))
    out(f"synthetic 'chess' profile: {len(db)} transactions, "
        f"{prof.n_dense_items} items, min_support={min_support}, "
        f"device={dev}")

    ref = mine_serial(bitmaps, min_support, max_k=max_k)
    out(f"serial Apriori: {len(ref)} frequent itemsets\n")
    done = {"min_support": min_support, "serial": ref, "policies": {},
            "granularities": {}}

    for policy in POLICIES:
        res, met = mine(bitmaps, min_support, policy=policy,
                        n_workers=n_workers, max_k=max_k,
                        granularity="candidate", **knobs)
        if res != ref:
            raise SystemExit(f"{policy} result differs from mine_serial")
        done["policies"][policy] = (res, met)
        s = met.scheduler
        out(f"[{policy:9s}] wall={met.wall_s:6.2f}s  "
            f"prefix-cache hit rate={met.cache_hit_rate:6.1%}  "
            f"steals={int(s['steals']):5d}  "
            f"tasks/steal={s['tasks_per_steal']:.2f}")

    out("\nThe clustered policy runs tasks that share a (k-1)-prefix "
        "back-to-back\non one worker, so the prefix intersection is "
        "computed once and reused —\nthe paper's dTLB/IPC win, "
        "observable here as the cache-hit-rate gap.\n")

    for gran in GRANULARITIES:
        res, met = mine(bitmaps, min_support, policy="clustered",
                        n_workers=n_workers, max_k=max_k, granularity=gran,
                        **knobs)
        if res != ref:
            raise SystemExit(f"granularity={gran} result differs from "
                             f"mine_serial")
        done["granularities"][gran] = (res, met)
        out(f"[granularity={gran:11s}] wall={met.wall_s:6.2f}s  "
            f"tasks={int(met.scheduler['tasks_run']):6d}  "
            f"rows touched={met.rows_touched:8d}  "
            f"cache misses={met.cache_misses:6d}  "
            f"batch occupancy={met.batch_occupancy:5.2f}  "
            f"h2d={met.h2d_bytes:8d}B  "
            f"peak retained bitmaps={met.peak_retained_bitmaps}")

    out("\nOn one device a candidate task joins its rows on the host "
        "(the per-worker\nprefix cache is host memory), so the policy "
        "comparison above is a host\ncomparison. Bucket granularity makes "
        "the bucket the unit of task\nexecution: the prefix intersection "
        "happens once per bucket and the\nextensions are swept through "
        "one handle-based request on the sweep\ndispatcher, which "
        "coalesces many workers' buckets into one launch of\nthe CUDA "
        "bitmap_join_many kernel (its plain PyTorch version on the\nCPU) "
        "on the arena's device mirror — fewer rows touched, fewer "
        "tasks,\nsame supports. Every bitmap lives in one refcounted "
        "arena, so the card\nsees ~one initial upload (h2d above) instead "
        "of per-sweep transfers.\n\n"
        "Depth-first granularity goes barrier-free: each class task "
        "spawns its\nchild equivalence classes onto its own worker and "
        "hands each child the\nalready-intersected prefix∧ext arena "
        "handle, so no prefix is ever\nrecomputed (cache misses: zero) "
        "and only one terminal wait remains. The\nprice is the "
        "retained-bitmap peak printed above — bounded by depth-first\n"
        "drain order, and measured.")
    return done


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="FPM quickstart (PyTorch/CUDA)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "numpy", "torch"],
                    help="join backend: auto (the CUDA kernels) | numpy "
                         "(host path) | torch")
    ap.add_argument("--arena", default="auto", choices=list(ARENA_BACKINGS),
                    help="bitmap arena backing (device residency)")
    ap.add_argument("--max-batch", type=int, default=32,
                    help="sweep dispatcher: max requests per launch")
    ap.add_argument("--flush-us", type=float, default=200.0,
                    help="sweep dispatcher: straggler wait before a "
                         "partial flush")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard the run over N devices (logical shards "
                         "on a host with fewer cards); 0 = shared-memory")
    ap.add_argument("--device", default="cuda",
                    help="where the mines run: cuda (default; raises "
                         "without a card) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    run(device, backend=args.backend, arena=args.arena,
        max_batch=args.max_batch, flush_us=args.flush_us,
        mesh=mesh_over_devices(args.mesh))


if __name__ == "__main__":
    main()
