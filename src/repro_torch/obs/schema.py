"""The one documented stats-dict schema every layer reports through.

Before this module, the repo had two drifting ``merged_stats()``
conventions — the scheduler returned a mixed int/float dict whose
derived ratio was recomputed by hand at three call sites
(``TaskScheduler.merged_stats``, ``MiningRun.finalize``,
``cluster.merge_metrics``), while the serving layer's
``PatternServer.merged_stats`` returned bare query counters with its
own derived total. This module is now the single place those shapes
are defined: COUNTER keys are monotonic ints (summable across workers,
hosts, and deltas), DERIVED keys are floats recomputed from counters
after any merge/delta — never summed, never subtracted.

Normalizers (``scheduler_stats``/``device_stats``/``query_stats``/
``host_stats``) take a raw counter mapping and return a fully-typed
dict with every schema key present; ``validate`` checks an arbitrary
dict against a schema (the tests run both real producers through it).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

__all__ = [
    "SCHEDULER_COUNTERS", "SCHEDULER_DERIVED",
    "DEVICE_ID_KEYS", "DEVICE_COUNTERS", "DEVICE_DERIVED",
    "QUERY_COUNTERS", "QUERY_DERIVED",
    "HOST_ID_KEYS", "HOST_COUNTERS", "HOST_DERIVED",
    "scheduler_stats", "device_stats", "query_stats", "host_stats",
    "merge_counters", "delta_counters", "validate",
]

# ---- scheduler: TaskScheduler.merged_stats / MiningMetrics.scheduler --
SCHEDULER_COUNTERS: Tuple[str, ...] = (
    "tasks_run", "spawned", "steals", "tasks_stolen", "steal_attempts",
    "bucket_switches", "steal_migrations", "rows_touched",
    "bytes_swept", "sweeps_submitted", "dense_sweeps", "sparse_sweeps",
    "sparse_bytes_swept",
)
SCHEDULER_DERIVED: Tuple[str, ...] = ("tasks_per_steal",)

# ---- per-device: dispatcher gauges / MiningMetrics.per_device rows --
DEVICE_ID_KEYS: Tuple[str, ...] = ("device",)      # +"host" in cluster rows
DEVICE_COUNTERS: Tuple[str, ...] = (
    "flushes", "sweep_requests", "query_requests", "queue_flushes",
    "queue_requests",
)
DEVICE_DERIVED: Tuple[str, ...] = ("batch_occupancy", "sweep_s")

# ---- serving: PatternServer.merged_stats / TenantHub.tenant_stats --
QUERY_COUNTERS: Tuple[str, ...] = ("hit", "sweep", "top_k")
QUERY_DERIVED: Tuple[str, ...] = ("queries",)       # int derived: sum

# ---- per-host: cluster merge_metrics MiningMetrics.per_host rows --
HOST_ID_KEYS: Tuple[str, ...] = ("host",)
HOST_COUNTERS: Tuple[str, ...] = ("bytes_swept", "eval_bytes")
HOST_DERIVED: Tuple[str, ...] = ("sweep_s", "eval_s")


def scheduler_stats(raw: Mapping[str, Any]) -> Dict[str, Any]:
    """Normalize scheduler counters; recompute the derived ratio."""
    out: Dict[str, Any] = {k: int(raw.get(k, 0))
                           for k in SCHEDULER_COUNTERS}
    out["tasks_per_steal"] = (out["tasks_stolen"]
                              / max(out["steals"], 1))
    return out


def device_stats(raw: Mapping[str, Any]) -> Dict[str, Any]:
    """Normalize one dispatcher's gauge row (``device`` id preserved,
    ``host`` passed through when a cluster merge stamped one)."""
    out: Dict[str, Any] = {"device": int(raw.get("device", 0))}
    if "host" in raw:
        out["host"] = int(raw["host"])
    for k in DEVICE_COUNTERS:
        out[k] = int(raw.get(k, 0))
    out["batch_occupancy"] = (out["sweep_requests"] / out["flushes"]
                              if out["flushes"] else 0.0)
    out["sweep_s"] = float(raw.get("sweep_s", 0.0))
    return out


def query_stats(raw: Mapping[str, Any]) -> Dict[str, Any]:
    """Normalize per-kind query counters; ``queries`` is their sum."""
    out: Dict[str, Any] = {k: int(raw.get(k, 0)) for k in QUERY_COUNTERS}
    out["queries"] = sum(out[k] for k in QUERY_COUNTERS)
    return out


def host_stats(raw: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {"host": int(raw.get("host", 0))}
    for k in HOST_COUNTERS:
        out[k] = int(raw.get(k, 0))
    for k in HOST_DERIVED:
        out[k] = float(raw.get(k, 0.0))
    return out


def merge_counters(rows, counters: Tuple[str, ...]) -> Dict[str, int]:
    """Sum counter keys across rows (derived keys are NOT summable —
    rebuild them with the schema's normalizer afterwards)."""
    out = {k: 0 for k in counters}
    for row in rows:
        for k in counters:
            out[k] += int(row.get(k, 0))
    return out


def delta_counters(now: Mapping[str, Any], base: Mapping[str, Any],
                   counters: Tuple[str, ...]) -> Dict[str, int]:
    """now − base over counter keys only (a derived ratio's delta is
    meaningless; rebuild it from the counter deltas)."""
    return {k: int(now.get(k, 0)) - int(base.get(k, 0))
            for k in counters}


_SCHEMAS = {
    "scheduler": ((), SCHEDULER_COUNTERS, SCHEDULER_DERIVED),
    "device": (DEVICE_ID_KEYS, DEVICE_COUNTERS, DEVICE_DERIVED),
    "query": ((), QUERY_COUNTERS, QUERY_DERIVED),
    "host": (HOST_ID_KEYS, HOST_COUNTERS, HOST_DERIVED),
}


def validate(kind: str, stats: Mapping[str, Any]) -> None:
    """Raise ``ValueError`` unless ``stats`` carries every schema key
    with the schema type (counters int, derived float — ``query``'s
    derived total is an int sum). Extra keys: only ``host`` on device
    rows (the cluster merge's stamp)."""
    ids, counters, derived = _SCHEMAS[kind]
    for k in ids + counters:
        if k not in stats:
            raise ValueError(f"{kind} stats missing key {k!r}")
        if not isinstance(stats[k], int) or isinstance(stats[k], bool):
            raise ValueError(
                f"{kind} stats key {k!r} must be int, "
                f"got {type(stats[k]).__name__}")
    for k in derived:
        if k not in stats:
            raise ValueError(f"{kind} stats missing derived key {k!r}")
        want = int if (kind, k) == ("query", "queries") else float
        if not isinstance(stats[k], want):
            raise ValueError(
                f"{kind} stats derived key {k!r} must be "
                f"{want.__name__}, got {type(stats[k]).__name__}")
    allowed = set(ids) | set(counters) | set(derived)
    if kind == "device":
        allowed.add("host")
    extra = set(stats) - allowed
    if extra:
        raise ValueError(f"{kind} stats has off-schema keys {sorted(extra)}")
