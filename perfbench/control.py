"""The control of the check: the reference in the program's place, with
one guarantee of the configuration broken, must come out not correct.

The configuration guarantees exact supports over every receipt the
database (or the published generation) holds. Each kind of traffic
breaks it the way a shortcut would, in the ``control`` of its module
(``perfbench/traffic/<kind>.py``): a mine drops the database's last 32
receipts (one bitmap word); a stream publishes the generation before
the last batch.

It reports the number the check compares (``itemsets_wrong``); the
benchmark's own runs never run it. On the card, at a cell's own size:

    python3 perfbench/control.py --workload <cell> --seeds 11 12 13
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(root: Path, name: str, seed: int,
                    device: str = "cuda") -> Dict[str, int]:
    from perfbench import spec, workload
    cell = spec.resolve(root, name)
    module = workload.kind_module(root, cell.traffic["kind"])
    return module.control(cell.config, cell.traffic, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the check's control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = control_numbers(ROOT, args.workload, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
