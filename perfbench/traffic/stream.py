"""Kind ``stream``: a closed ingest → refresh loop over one StreamingMiner.

Set-up fills a ``StreamingMiner`` with the configuration's database,
refreshes it (the initial mine) and runs ``warmup`` cycles. The window
then ingests the next ``batch`` receipts of the same generator (the
receipts that follow the database, each batch in an order drawn from
the seed), refreshes to a published snapshot, and repeats. The pool
holds ``pool_batches`` distinct batches; a window that would need more
fails rather than ingest a receipt twice. Reports the mix's ``metric``
(the window's time over the cycles completed), then answers ``queries``
support queries through a ``PatternServer`` once the window has closed.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from perfbench import check
from perfbench.reference import miner as ref
from perfbench.workload import (TRACER_RING, Readings, align, engine_kwargs,
                                receipts, shuffled)


def stream_pool(config: Dict[str, Any], traffic: Dict[str, Any],
                seed: int) -> List[List[int]]:
    """A stream's receipts: the database, then ``pool_batches`` batches
    of ``batch``, each block in its own order drawn from ``seed``."""
    n0, b, nb = (config["n_transactions"], traffic["batch"],
                 traffic["pool_batches"])
    return shuffled(receipts(config, n0 + nb * b), seed,
                    [0] + [n0 + j * b for j in range(nb + 1)])


class Loop:
    """A closed ingest → refresh loop over one ``StreamingMiner``."""

    between_levels = ("cycle outside its levels (ingest, delta plan, "
                      "assembly, publish)")

    def __init__(self, config, traffic, seed, device, trace):
        from repro_torch import PatternServer, StreamingMiner
        from repro_torch.obs import Tracer
        self.config, self.traffic, self.device = config, traffic, device
        self.seed = seed
        n0 = config["n_transactions"]
        t0 = time.perf_counter()
        self.pool = stream_pool(config, traffic, seed)
        t1 = time.perf_counter()
        self.tracer = Tracer(ring_size=TRACER_RING) if trace else None
        kw = engine_kwargs(config)
        self.miner = StreamingMiner(
            config["n_items"], float(config["support"]),
            initial_db=self.pool[:n0], device=device, max_k=kw.pop("max_k"),
            tracer=self.tracer, **kw)
        self.server = PatternServer(self.miner)
        self.miner.refresh()
        t2 = time.perf_counter()
        self.batches = 0                 # batches ingested so far
        self.generations: List[Tuple[int, Any]] = []
        for _ in range(traffic.get("warmup", 1)):
            self._cycle()
        self.setup_note = (f"receipts {t1 - t0:.3f} s, initial mine "
                           f"{t2 - t1:.3f} s, warm-up "
                           f"{time.perf_counter() - t2:.3f} s")
        self.readings = Readings()
        self.answers: Optional[Tuple[list, list]] = None

    def _batch(self, i: int) -> List[List[int]]:
        n0, b = self.config["n_transactions"], self.traffic["batch"]
        if i >= self.traffic["pool_batches"]:
            raise RuntimeError(
                f"the stream's {self.traffic['pool_batches']} batches are "
                "spent: a window may not ingest a receipt twice; raise "
                "pool_batches in a new traffic mix")
        return self.pool[n0 + i * b:n0 + (i + 1) * b]

    def _cycle(self):
        self.miner.ingest(self._batch(self.batches))
        self.batches += 1
        return self.miner.refresh()

    def window(self, seconds: float) -> Dict[str, float]:
        rd = self.readings
        if self.tracer is not None:
            host, ts = align(self.tracer, "window-open")
            rd.tracers.append((self.tracer, host, ts))
            rd.window_ts = ts
        t_open = time.perf_counter()
        deadline = t_open + seconds
        while time.perf_counter() < deadline:
            a = time.perf_counter()
            rep = self._cycle()
            b = time.perf_counter()
            rd.calls.append((a, b))
            rd.refresh_reports.append(rep)
            self.generations.append((self.batches, self.miner.snapshot))
        rd.window = (t_open, time.perf_counter())
        self._serve()
        return {self.traffic["metric"]: rd.window_s / len(rd.calls)}

    def _serve(self) -> None:
        """``queries`` support queries on the last generation, drawn from
        the seed: frequent itemsets (hits), frequent itemsets with one
        more frequent item, and pairs of frequent items (mostly never
        counted, so swept through the dispatcher)."""
        snap = self.miner.snapshot
        rng = np.random.default_rng([self.seed % (1 << 63), 1])
        frequent = sorted(snap.supports)
        singles = [x[0] for x in frequent if len(x) == 1]
        qs = []
        for i in range(self.traffic["queries"]):
            x = frequent[int(rng.integers(len(frequent)))]
            if i % 3 == 1:
                x = x + (singles[int(rng.integers(len(singles)))],)
            elif i % 3 == 2:
                x = tuple(int(v) for v in rng.choice(singles, 2,
                                                     replace=False))
            qs.append(tuple(sorted(set(x))))
        self.answers = (qs, self.server.support_many(qs))

    def attempted(self) -> int:
        return len(self.readings.calls)

    def summary(self) -> str:
        cycles = " ".join(
            f"{r.frequent}/{r.reused}/{r.swept_delta}/{r.swept_full}/"
            f"{r.compacted_segments}" for r in self.readings.refresh_reports)
        return f"refreshes (frequent/reused/delta/full/compacted): {cycles}"

    def release(self) -> None:
        self.miner.close()
        self.miner = self.server = None

    def _db(self, batches: int) -> List[List[int]]:
        n0 = self.config["n_transactions"]
        db = list(self.pool[:n0])
        for i in range(batches):
            db.extend(self._batch(i))
        return db

    def check(self) -> Tuple[Dict[str, int], int]:
        """The last generation of the window and ``check_generations``
        - 1 others drawn from the seed, each against a reference mine of
        the receipts it covers; the queries against reference counts on
        the last generation's receipts."""
        n_items, max_k = self.config["n_items"], self.config["max_k"]
        gens = self.generations
        rng = np.random.default_rng([self.seed % (1 << 63), 2])
        extra = min(len(gens) - 1, self.traffic["check_generations"] - 1)
        picks = sorted(rng.choice(len(gens) - 1, extra, replace=False)
                       .tolist()) + [len(gens) - 1]
        wrong, failed = 0, 0
        for i in picks:
            batches, snap = gens[i]
            db = self._db(batches)
            ms = ref.min_support_count(float(self.config["support"]),
                                       len(db))
            want = ref.mine(db, n_items, ms, max_k, device=self.device)
            w = check.itemsets_wrong(snap.supports, want)
            if snap.min_support != ms or snap.n_transactions != len(db):
                w += 1
            wrong += w
            failed += bool(w)
            del want
        qs, got = self.answers
        rows = ref.pack(self._db(gens[-1][0]), n_items, self.device)
        want_q = [ref.support_of(rows, q) for q in qs]
        q_wrong = check.queries_wrong(got, want_q)
        return ({"itemsets_wrong": wrong, "queries_wrong": q_wrong},
                failed + bool(q_wrong))


def control(config, traffic, seed, device) -> Dict[str, int]:
    """The published generation is the one before: the reference of the
    receipts before the last batch stands in for the refresh that should
    have folded that batch in, at the generation a window reaches after
    its warm-up cycle and a few more."""
    n0, b = config["n_transactions"], traffic["batch"]
    n_items, max_k = config["n_items"], config["max_k"]
    frac = float(config["support"])
    g = min(traffic.get("warmup", 1) + 4, traffic["pool_batches"])
    db = stream_pool(config, traffic, seed)[:n0 + g * b]
    prev = db[:n0 + (g - 1) * b]
    want = ref.mine(db, n_items, ref.min_support_count(frac, len(db)),
                    max_k, device=device)
    got = ref.mine(prev, n_items, ref.min_support_count(frac, len(prev)),
                   max_k, device=device)
    return {"itemsets_wrong": check.itemsets_wrong(got, want)}
