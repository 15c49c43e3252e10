"""Kind ``mine``: back-to-back batch mines of the configuration's database.

One caller (a closed loop, one client) calls ``repro_torch.mine`` over
the whole database, one call after another; each call builds and
uploads its own arena, as a user's call does. Reports the mix's
``metric``: the window's time over the mines completed.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

from perfbench import check
from perfbench.reference import miner as ref
from perfbench.workload import (TRACER_RING, Readings, align, engine_kwargs,
                                receipts, shuffled)

# the control drops this many receipts from the end of the database: one
# bitmap word, as a sweep that loses its tail word would
TAIL = 32


class Loop:
    """Back-to-back ``repro_torch.mine`` calls over one database."""

    between_levels = "mine outside its levels (arena build, level 1)"

    def __init__(self, config, traffic, seed, device, trace):
        import repro_torch
        from repro_torch.core.tidlist import pack_database
        self.config, self.traffic, self.device = config, traffic, device
        self.trace = trace
        t0 = time.perf_counter()
        n0 = config["n_transactions"]
        self.db = shuffled(receipts(config, n0), seed, [0, n0])
        t1 = time.perf_counter()
        self.bitmaps, self.counts = pack_database(
            self.db, config["n_items"], return_counts=True)
        t2 = time.perf_counter()
        self.min_support = ref.min_support_count(config["support"],
                                                 len(self.db))
        self._mine = repro_torch.mine
        self.kw = engine_kwargs(config)
        for _ in range(traffic.get("warmup", 1)):
            self._call(None)
        self.setup_note = (f"receipts {t1 - t0:.3f} s, pack {t2 - t1:.3f} s, "
                           f"warm-up {time.perf_counter() - t2:.3f} s")
        self.results: List[Dict] = []
        self.readings = Readings()

    def _call(self, tracer):
        return self._mine(self.bitmaps, self.min_support,
                          device=self.device, item_counts=self.counts,
                          trace=tracer, **self.kw)

    def window(self, seconds: float) -> Dict[str, float]:
        from repro_torch.obs import Tracer
        rd = self.readings
        t_open = time.perf_counter()
        deadline = t_open + seconds
        while time.perf_counter() < deadline:
            tracer = None
            if self.trace:
                tracer = Tracer(ring_size=TRACER_RING)
                rd.tracers.append((tracer, *align(tracer, "align")))
            a = time.perf_counter()
            result, met = self._call(tracer)
            b = time.perf_counter()
            rd.calls.append((a, b))
            rd.mine_metrics.append(met)
            self.results.append(result)
        rd.window = (t_open, time.perf_counter())
        return {self.traffic["metric"]: rd.window_s / len(self.results)}

    def attempted(self) -> int:
        return len(self.results)

    def summary(self) -> str:
        mets = self.readings.mine_metrics
        return ("mines: itemsets " + " ".join(str(len(r))
                                              for r in self.results)
                + "; flushes " + " ".join(str(m.flushes) for m in mets))

    def release(self) -> None:
        self.bitmaps = self.counts = None

    def check(self) -> Tuple[Dict[str, int], int]:
        """Every mine of the window against one reference mine."""
        want = ref.mine(self.db, self.config["n_items"], self.min_support,
                        self.config["max_k"], device=self.device)
        wrong = [check.itemsets_wrong(r, want) for r in self.results]
        return {"itemsets_wrong": sum(wrong)}, sum(1 for w in wrong if w)


def control(config, traffic, seed, device) -> Dict[str, int]:
    """The reference mines the database without its last ``TAIL``
    receipts at the database's own threshold, in the program's place."""
    n0 = config["n_transactions"]
    db = shuffled(receipts(config, n0), seed, [0, n0])
    ms = ref.min_support_count(float(config["support"]), len(db))
    want = ref.mine(db, config["n_items"], ms, config["max_k"],
                    device=device)
    got = ref.mine(db[:-TAIL], config["n_items"], ms, config["max_k"],
                   device=device)
    return {"itemsets_wrong": check.itemsets_wrong(got, want)}
