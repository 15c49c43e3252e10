"""Multi-device FPM through the port's task engine: ``mine(mesh=)`` runs
every granularity over device shards — a sharded bitmap arena (one set
of mirrors per shard), one sweep dispatcher and kernel backend per
shard, shard-affine workers whose cross-shard bucket steals migrate the
bucket's retained rows.

Eight shards: the first eight CUDA devices when the host has them, else
eight logical shards on the one card (eight mirrors, dispatchers and
backends on one device).

Run on the card:  PYTHONPATH=src python examples/torch_distributed_mining.py
On the host:      PYTHONPATH=src python examples/torch_distributed_mining.py \
                      --device cpu
Without a CUDA device and without ``--device cpu`` it raises
``RuntimeError``.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.distributed_fpm import mine_distributed  # noqa: E402
from repro_torch.core.fpm import mesh_over_devices, mine, mine_serial  # noqa: E402
from repro_torch.core.tidlist import pack_database, resolve_device  # noqa: E402
from repro_torch.data.transactions import load  # noqa: E402

GRANULARITIES = ("bucket", "depth-first")
POLICIES = ("round_robin", "clustered")
N_SHARDS = 8
N_WORKERS = 8


def run(device="cuda", *, backend="auto", n_transactions=2500, max_k=4,
        out=print):
    """The script's mines on ``device``: ``mine(mesh=)`` over
    ``N_SHARDS`` shards at bucket and depth-first grain, then
    ``mine_distributed`` under each policy, every result checked equal
    to ``mine_serial``. On the CPU the shards are logical; on the card
    :func:`mesh_over_devices` picks real devices when the host has
    enough. Returns ``{"min_support", "serial", "granularities":
    {granularity: (res, met, wall)}, "policies": {policy: (res, stats,
    wall)}}``."""
    dev = resolve_device(device)
    db, p = load("mushroom", seed=0)
    db = db[:n_transactions]
    bm = pack_database(db, p.n_dense_items)
    ms = int(0.22 * len(db))
    mesh = N_SHARDS if dev.type == "cpu" else mesh_over_devices(N_SHARDS)
    where = ("logical shards" if isinstance(mesh, int)
             else "cuda devices")
    out(f"{len(db)} transactions over {N_SHARDS} {where} on {dev}, "
        f"min_support={ms}")
    ref = mine_serial(bm, ms, max_k=max_k)
    done = {"min_support": ms, "serial": ref, "granularities": {},
            "policies": {}}

    # the unified engine: every granularity runs distributed
    for gran in GRANULARITIES:
        t0 = time.time()
        res, met = mine(bm, ms, mesh=mesh, device=dev, backend=backend,
                        granularity=gran, policy="clustered",
                        n_workers=N_WORKERS, max_k=max_k)
        wall = time.time() - t0
        if res != ref:
            raise SystemExit(f"granularity={gran} result differs from "
                             f"mine_serial")
        done["granularities"][gran] = (res, met, wall)
        occ = "/".join(f"{d['batch_occupancy']:.1f}" for d in met.per_device)
        out(f"[{gran:11s}] wall={wall:5.2f}s "
            f"rows_touched={met.rows_touched:7d} "
            f"d2d={met.d2d_bytes}B migrations={met.migrations} "
            f"dev_occupancy={occ} cache_misses={met.cache_misses}")

    # the two-policy API is a shim over the same engine
    for pol in POLICIES:
        t0 = time.time()
        res, stats = mine_distributed(bm, ms, mesh, policy=pol, max_k=max_k,
                                      device=dev, backend=backend)
        wall = time.time() - t0
        if res != ref:
            raise SystemExit(f"mine_distributed({pol}) result differs from "
                             f"mine_serial")
        done["policies"][pol] = (res, stats, wall)
        out(f"[{pol:11s}] wall={wall:5.2f}s "
            f"rows_touched={stats['rows_touched']:7d} "
            f"candidates={stats['candidates']}")
    out("clustered placement touches fewer bitmap rows (prefix joined "
        "once per bucket), and depth-first carries its zero-recompute "
        "handoff onto the mesh: cross-device traffic is explicit "
        "(d2d bytes = fetched rows + migrated bucket bitmaps).")
    return done


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="FPM over eight device shards (PyTorch/CUDA)")
    ap.add_argument("--device", default="cuda",
                    help="where the mines run: cuda (default; raises "
                         "without a card) or cpu")
    args = ap.parse_args(argv)
    run(resolve_device(args.device))


if __name__ == "__main__":
    main()
