"""Streaming quickstart of the PyTorch/CUDA port: ingest batches, refresh
incrementally, serve queries between (and during) refreshes.

Run on the card:  PYTHONPATH=src python examples/torch_streaming_patterns.py
On the host:      PYTHONPATH=src python examples/torch_streaming_patterns.py \
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

from repro_torch.core.streaming import PatternServer, StreamingMiner  # noqa: E402
from repro_torch.core.tidlist import resolve_device  # noqa: E402
from repro_torch.data.transactions import load  # noqa: E402


def run(device="cuda", *, backend="auto", n_initial=10000, n_batches=4,
        batch_size=None, n_workers=4, max_k=5, out=print):
    """The script's stream on ``device``: the first ``n_initial``
    'retail' transactions mined, then ``n_batches`` ingests of
    ``batch_size`` transactions each (None: the rest of the database in
    equal parts), each followed by a top-3 query on the published
    generation and a refresh. Returns ``{"generations": [(refresh
    report, supports)], "ingests": [ingest report], "top3": [answer],
    "itemset", "support"}``."""
    dev = resolve_device(device)
    db, prof = load("retail", seed=0)
    init, stream = db[:n_initial], db[n_initial:]
    step = batch_size or len(stream) // n_batches
    done = {"generations": [], "ingests": [], "top3": []}

    # fraction-based threshold: it rises as the database grows, so the
    # frequent border moves both ways (births AND deaths)
    miner = StreamingMiner(prof.n_items, prof.support, initial_db=init,
                           device=dev, backend=backend,
                           n_workers=n_workers, max_k=max_k)
    try:
        server = PatternServer(miner)

        def refreshed():
            rep = miner.refresh()
            done["generations"].append(
                (rep, dict(miner.snapshot.supports)))
            return rep

        rep = refreshed()
        out(f"gen {rep.generation}: {rep.frequent} frequent itemsets "
            f"over {rep.n_transactions} transactions "
            f"({rep.wall_s:.2f}s from scratch) on {dev}")

        for i in range(n_batches):
            batch = stream[i * step:(i + 1) * step]
            ing = miner.ingest(batch)
            done["ingests"].append(ing)
            out(f"  ingested {ing.n_transactions} tx as segment "
                f"{ing.segment} ({ing.payload_bytes} B packed)")
            # queries keep answering from the published generation —
            # ingest never blocks them, refresh never blocks them
            hot = server.top_k((), 3)
            done["top3"].append(hot)
            out(f"  serving gen {server.snapshot.generation}, top-3 {hot}")
            rep = refreshed()
            out(f"gen {rep.generation}: {rep.frequent} frequent | "
                f"border +{rep.born}/-{rep.died} | candidates: "
                f"{rep.reused} reused, {rep.swept_delta} delta-swept, "
                f"{rep.swept_full} fully swept | {rep.rows_touched} "
                f"rows in {rep.wall_s:.2f}s")

        itemset = server.top_k((), 1)[0][0]
        done["itemset"] = itemset
        done["support"] = server.support(itemset)
        out(f"support{itemset} = {done['support']} "
            f"at generation {server.snapshot.generation}")
    finally:
        miner.close()
    return done


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="streaming FPM with query serving (PyTorch/CUDA)")
    ap.add_argument("--device", default="cuda",
                    help="where the miner runs: cuda (default; raises "
                         "without a card) or cpu")
    args = ap.parse_args(argv)
    run(resolve_device(args.device))


if __name__ == "__main__":
    main()
