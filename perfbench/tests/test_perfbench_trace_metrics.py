"""The per-layer metrics that read the program's host-work spans
(``perfbench/spans.py``), on hand-placed spans: each reads its exact
value, spans outside the window are left out, and a run whose program
recorded no such span reads None. Then a traced CPU window of each kind
reports them beside the metrics it reported before."""
from __future__ import annotations

import pytest

from perfbench import harness, spec
from perfbench.tests.conftest import ROOT
from perfbench.workload import Readings
from repro_torch.obs import TraceEvent


class Spans:
    """A tracer's ``events()`` with hand-placed events."""

    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def X(name, ts, dur, lane, args=None, tid=1, cat="host"):
    return TraceEvent("X", name, cat, ts, dur, args, 0, tid, lane)


def read(metric, rd):
    return spec.metric_reader(ROOT, metric)(rd)


def mine_readings(new_spans=True):
    """Two mines, each with its own tracer whose timeline starts at 0
    (host clock 10 and 20); the window spans both."""
    def flush(ts, dur, fid):
        return X("flush", ts, dur, "dispatcher-0",
                 {"flush": fid} if new_spans else {}, tid=2, cat="flush")

    first = [X("level-2", 0.5, 1.0, "driver", cat="level"),
             X("sweep", 1.0, 0.02, "worker-0",
               {"ext": 3, "flush": 1, "queued_s": 0.001}, tid=3,
               cat="sweep"),
             X("sweep", 1.1, 0.02, "worker-1",
               {"ext": 3, "flush": 2, "queued_s": 0.003}, tid=4,
               cat="sweep"),
             flush(1.0, 0.010, 1),
             X("h2d-sync", 1.0005, 0.001, "dispatcher-0", tid=2,
               cat="arena"),
             flush(2.0, 0.004, 2)]
    second = [flush(1.0, 0.005, 3)]
    if new_spans:
        first += [X("candidates", 0.5, 0.010, "driver"),
                  X("plan", 0.51, 0.020, "driver"),
                  X("collect", 1.4, 0.030, "driver"),
                  X("candidates", 1.6, 0.001, "driver"),
                  X("launch", 1.002, 0.003, "dispatcher-0", tid=2,
                    cat="flush"),
                  X("launch", 2.001, 0.002, "dispatcher-0", tid=2,
                    cat="flush"),
                  X("gc", 0.7, 0.100, "gc", {"generation": 2}, tid=9,
                    cat="gc")]
        second += [X("candidates", 0.2, 0.004, "driver"),
                   X("plan", 0.3, 0.006, "driver"),
                   X("collect", 0.6, 0.010, "driver"),
                   X("gc", 0.4, 0.020, "gc", tid=9, cat="gc"),
                   X("gc", 0.5, 0.030, "gc", tid=9, cat="gc")]
    else:
        first[1] = X("sweep", 1.0, 0.02, "worker-0", {"ext": 3}, tid=3,
                     cat="sweep")
        first[2] = X("sweep", 1.1, 0.02, "worker-1", {"ext": 3}, tid=4,
                     cat="sweep")
    rd = Readings(window=(9.0, 30.0), calls=[(10.0, 12.0), (20.0, 21.0)])
    rd.tracers = [(Spans(first), 10.0, 0.0), (Spans(second), 20.0, 0.0)]
    return rd


def stream_readings(new_spans=True):
    """One tracer over the stream's life: the window opens at its ts 5
    and closes at ts 15 (host clock 25); two cycles."""
    events = [X("flush", 6.0, 0.008, "dispatcher-0", {"flush": 7}, tid=2,
                cat="flush"),
              X("flush", 4.0, 0.008, "dispatcher-0", {"flush": 6}, tid=2,
                cat="flush"),
              X("flush", 20.0, 0.008, "dispatcher-0", {"flush": 9}, tid=2,
                cat="flush")]
    if new_spans:
        events += [X("launch", 6.001, 0.003, "dispatcher-0", tid=2,
                     cat="flush"),
                   X("launch", 4.001, 0.001, "dispatcher-0", tid=2,
                     cat="flush"),
                   X("dirty-items", 6.0, 0.002, "driver"),
                   X("candidates", 6.1, 0.003, "driver"),
                   X("plan", 6.2, 0.004, "driver"),
                   X("collect", 6.3, 0.005, "driver"),
                   X("drop-unswept", 6.4, 0.006, "driver"),
                   X("assemble", 6.5, 0.007, "driver"),
                   X("assemble", 3.0, 0.5, "driver"),
                   X("plan", 16.0, 0.5, "driver"),
                   X("gc", 7.0, 0.010, "gc", tid=9, cat="gc"),
                   X("gc", 4.5, 0.5, "gc", tid=9, cat="gc")]
    rd = Readings(window=(15.0, 25.0), calls=[(15.0, 20.0), (20.0, 25.0)],
                  window_ts=5.0)
    rd.tracers = [(Spans(events), 15.0, 5.0)]
    return rd


@pytest.mark.parametrize("metric,want", [
    ("plan_ms.mine", 1e3 * (0.010 + 0.020 + 0.030 + 0.001
                            + 0.004 + 0.006 + 0.010) / 2),
    ("gc_ms.mine", 1e3 * (0.100 + 0.020 + 0.030) / 2),
    ("queue_wait_ms.mine", 1e3 * (0.001 + 0.003) / 2),
    # flush self-time outside launch and h2d-sync; the second mine's
    # flush shares the first's lane id but not its timeline
    ("flush_pack_ms.mine", 1e3 * ((0.010 - 0.003 - 0.001)
                                  + (0.004 - 0.002) + 0.005) / 3),
])
def test_mine_metric_reads_its_spans(metric, want):
    assert read(metric, mine_readings()) == pytest.approx(want)


@pytest.mark.parametrize("metric,want", [
    ("delta_plan_ms.refresh", 1e3 * (0.002 + 0.003 + 0.004 + 0.005
                                     + 0.006 + 0.007) / 2),
    ("gc_ms.refresh", 1e3 * 0.010 / 2),
    ("flush_pack_ms.refresh", 1e3 * (0.008 - 0.003)),
])
def test_refresh_metric_reads_the_window_only(metric, want):
    assert read(metric, stream_readings()) == pytest.approx(want)


@pytest.mark.parametrize("metric,readings", [
    ("plan_ms.mine", mine_readings), ("gc_ms.mine", mine_readings),
    ("queue_wait_ms.mine", mine_readings),
    ("flush_pack_ms.mine", mine_readings),
    ("delta_plan_ms.refresh", stream_readings),
    ("gc_ms.refresh", stream_readings),
    ("flush_pack_ms.refresh", stream_readings),
])
def test_metric_reads_none_without_its_spans(metric, readings):
    assert read(metric, readings(new_spans=False)) is None
    assert read(metric, Readings()) is None


@pytest.mark.parametrize("cell", ["tiny.mine", "tiny.stream"])
def test_traced_cpu_window_reports_the_host_work_metrics(tiny_root, cell):
    result, _ = harness.run(tiny_root, cell, 2**31 + 7, 0.5, True,
                            device="cpu", log=lambda _: None)
    assert result["correct"] is True
    kind = cell.split(".")[1]
    before = {"mine": {"flush_ms.mine", "occupancy.mine",
                       "blocked_share.mine", "h2d_mb.mine"},
              "stream": {"flush_ms.refresh", "reused_share.refresh",
                         "refresh_p95_s"}}[kind]
    new = {"mine": {"plan_ms.mine", "gc_ms.mine", "queue_wait_ms.mine",
                    "flush_pack_ms.mine"},
           "stream": {"flush_pack_ms.refresh", "gc_ms.refresh",
                      "delta_plan_ms.refresh"}}[kind]
    # a superset: other tests add metrics to the shared tiny benchmark
    assert set(result["metrics"]) >= before | new
    for name in new:
        assert result["metrics"][name]["value"] >= 0
        assert result["metrics"][name]["unit"] == "ms"
