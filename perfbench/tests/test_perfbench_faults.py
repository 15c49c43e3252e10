"""The check fails what it must: the control (the reference in the
program's place with a guarantee broken), and whole runs whose timed
path is broken underneath, once for each fault a cell can have."""
from __future__ import annotations

import numpy as np
import pytest

from perfbench import control, harness


def _run(root, cell, seconds=0.5):
    result, _ = harness.run(root, cell, 424242, seconds, False,
                            device="cpu", log=lambda _: None)
    return result


@pytest.mark.parametrize("cell", ["tiny.mine", "tiny.stream"])
def test_control_is_not_correct(tiny_root, cell):
    numbers = control.control_numbers(tiny_root, cell, 31, device="cpu")
    assert numbers["itemsets_wrong"] > 0


def _altered(orig):
    """Each flush's first count is one too many."""
    def sweep_many(self, arena, requests):
        out = [c.copy() for c in orig(self, arena, requests)]
        out[0][0] += 1
        return out
    return sweep_many


def _half_left_out(orig):
    """Each flush sweeps the first half of its requests; the rest get the
    mean count of those."""
    def sweep_many(self, arena, requests):
        keep = max(1, len(requests) // 2)
        out = orig(self, arena, requests[:keep])
        mean = int(np.mean(np.concatenate(out))) if out else 0
        return out + [np.full(len(r.ext_handles), mean, np.int64)
                      for r in requests[keep:]]
    return sweep_many


@pytest.mark.parametrize("cell", ["tiny.mine", "tiny.stream"])
@pytest.mark.parametrize("fault", [_altered, _half_left_out])
def test_broken_sweep_is_not_correct(tiny_root, monkeypatch, cell, fault):
    from repro_torch.core.join_backend import TorchBackend
    monkeypatch.setattr(TorchBackend, "sweep_many",
                        fault(TorchBackend.sweep_many))
    result = _run(tiny_root, cell)
    assert result["correct"] is False
    assert result["failed"] >= 1


def test_refresh_that_leaves_its_state_unchanged_is_not_correct(
        tiny_root, monkeypatch):
    from repro_torch.core import streaming
    monkeypatch.setattr(streaming, "mine_more", lambda *a, **k: None)
    # a refresh that does nothing takes a few ms a cycle on the CPU: a
    # short window stays inside the tiny stream's pool of batches
    result = _run(tiny_root, "tiny.stream", seconds=0.05)
    assert result["correct"] is False
    assert result["checks"]["itemsets_wrong"]["value"] > 0
