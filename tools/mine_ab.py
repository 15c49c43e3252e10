#!/usr/bin/env python3
"""Time the port's batch mine on the card in two checkouts, in turns.

    python3 tools/mine_ab.py --parent DIR [--rounds 2]

``DIR`` is the root of another checkout of this repository, for example
the parent commit unpacked with ``git archive`` into a directory that
git ignores. Each run is a fresh process that imports ``repro_torch``
from one checkout's ``src/``, builds that checkout's kernels, warms the
card with a short mine, then times one mine of ``chip_smoke.py``'s
phase 3: t10i4 at scale 5 (100,000 transactions x 500 items), min
support 0.5%, bucket granularity, ``representation="auto"``, clustered
policy, 8 workers, max_k=8. A round runs parent, change, change,
parent; the next round starts with the change. Each run prints one JSON
line (wall, flushes, occupancy, sweeps, h2d bytes, a digest of the
supports); the last line is a JSON summary with each side's walls and
median. Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(src: str) -> None:
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("mine_ab: no CUDA device available")
    import repro_torch
    from repro_torch.core.tidlist import pack_database
    from repro_torch.data.transactions import load, min_support_count
    from repro_torch.kernels import _build
    _build.build_all()
    db, prof = load("t10i4", scale=5)
    bitmaps, counts = pack_database(db, prof.n_items, return_counts=True)
    ms = min_support_count(prof, db)
    kw = dict(device="cuda", granularity="bucket", policy="clustered",
              representation="auto", item_counts=counts)
    repro_torch.mine(bitmaps, ms, max_k=2, **kw)          # warm-up
    t0 = time.perf_counter()
    result, met = repro_torch.mine(bitmaps, ms, max_k=8, **kw)
    wall = time.perf_counter() - t0
    digest = hashlib.sha256(
        repr(sorted(result.items())).encode()).hexdigest()[:16]
    print(json.dumps({
        "src": src, "wall_s": wall, "itemsets": len(result),
        "digest": digest, "flushes": met.flushes,
        "occupancy": met.batch_occupancy,
        "dense_sweeps": met.dense_sweeps,
        "sparse_sweeps": met.sparse_sweeps, "h2d_bytes": met.h2d_bytes,
        "card": torch.cuda.get_device_name(0)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return 0
    sides = {"parent": str(Path(args.parent).resolve() / "src"),
             "change": str(ROOT / "src")}
    walls = {"parent": [], "change": []}
    digests = set()
    for r in range(args.rounds):
        order = (["parent", "change", "change", "parent"] if r % 2 == 0
                 else ["change", "parent", "parent", "change"])
        for side in order:
            out = subprocess.run(
                [sys.executable, __file__, "--parent", args.parent,
                 "--child", sides[side]], capture_output=True, text=True)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                return out.returncode
            row = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps({"side": side, **row}), flush=True)
            walls[side].append(row["wall_s"])
            digests.add(row["digest"])
    if len(digests) != 1:
        print(f"supports differ between runs: {sorted(digests)}",
              file=sys.stderr)
        return 1
    print(json.dumps({side: {"walls": w, "median": statistics.median(w)}
                      for side, w in walls.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
