"""Compatibility wrapper: multi-device mining is the task engine.

``repro_torch.core.fpm.mine(mesh=...)`` runs every granularity over
device shards: the arena keeps one set of mirrors per shard (pinned item
rows replicated, a made row owned by the shard that made it, cross-shard
fetches in ``d2d_bytes``), one ``SweepDispatcher`` per shard launches the
batched kernels on its own mirror, and the scheduler's clustered
placement is shard placement (a cross-shard bucket steal migrates the
bucket's handoff rows).

``mine_distributed`` maps the old two-policy API onto that engine:

  clustered    → clustered placement at bucket granularity (the prefix
                 join computed once per bucket, extensions swept batched
                 — the owner-computes locality path).
  round_robin  → scattered FIFO placement at candidate granularity with
                 the prefix cache disabled (every candidate pays its full
                 k-way join — the no-locality baseline).

Both return identical supports; the locality difference shows in the
measured rows-touched counters (``repro_torch.core.buckets``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fpm import mine
from repro_torch.core.itemsets import Itemset

#                  fpm policy, granularity, cache_size
_POLICY_MAP = {
    "clustered":   ("clustered", "bucket", 32),
    "round_robin": ("fifo", "candidate", 0),
}


def mine_distributed(bitmaps: np.ndarray, min_support: int, mesh,
                     *, policy: str = "clustered", max_k: int = 6,
                     axis_name: Optional[str] = None, n_workers: int = 8,
                     backend: str = "auto",
                     device: "torch.device | str | None" = None,
                     ) -> Tuple[Dict[Itemset, object], Dict[str, object]]:
    """Level-synchronous distributed Apriori over ``fpm.mine(mesh=...)``.
    ``mesh`` is an int (logical shards on ``device``) or a list of
    ``torch.device``, one shard each. Returns (supports, stats) with the
    historical stats keys plus the mesh gauges (``d2d_bytes``,
    ``migrations``, ``n_devices``, ``per_device``).

    A device list has one axis, so the reference's refusal of a
    multi-axis jax mesh has no counterpart here; ``axis_name`` is
    accepted for the same call signature and names nothing."""
    if policy not in _POLICY_MAP:
        raise ValueError(policy)
    fpm_policy, granularity, cache_size = _POLICY_MAP[policy]
    result, met = mine(bitmaps, min_support, mesh=mesh, device=device,
                       policy=fpm_policy, granularity=granularity,
                       cache_size=cache_size, max_k=max_k,
                       n_workers=n_workers, backend=backend)
    stats = {
        "levels": met.levels,
        "candidates": met.candidates,
        "rows_touched": met.rows_touched,
        "bytes_swept": met.bytes_swept,
        "n_devices": met.n_devices,
        "d2d_bytes": met.d2d_bytes,
        "migrations": met.migrations,
        "per_device": met.per_device,
    }
    return result, stats
