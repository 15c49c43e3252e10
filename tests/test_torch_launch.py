"""The port's launcher against the reference's: the same dataset and
policies give the same frequent-itemset counts, ``--trace`` writes a
loadable Chrome trace, the flags of later slices raise, and without a
card the launcher refuses to start unless ``--device cpu`` is given."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import fpm_mine as rlaunch
from repro_torch.launch import fpm_mine as tlaunch

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--dataset", "mushroom", "--max-k", "3", "--workers", "2"]


def _policy_lines(out):
    return {m.group(1): m.group(0) for m in re.finditer(
        r"^(cilk|clustered|random|nn)\s+wall=.*$", out, re.M)}


def _serial_count(out):
    return int(re.search(r"^serial: (\d+) frequent itemsets", out,
                         re.M).group(1))


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_launcher_reproduces_reference_counts(monkeypatch, capsys, backend):
    monkeypatch.setattr(sys, "argv", ["fpm_mine", *SMALL, "--backend",
                                      "numpy"])
    rlaunch.main()
    want = capsys.readouterr().out
    tlaunch.main([*SMALL, "--device", "cpu", "--backend", backend])
    got = capsys.readouterr().out
    n = _serial_count(want)
    assert _serial_count(got) == n > 0
    lines = _policy_lines(got)
    assert set(lines) == set(_policy_lines(want)) == {"cilk", "clustered"}
    for policy, line in lines.items():
        assert f"frequent={n}" in line, line
        assert "flushes=" in line and "cache_hit=" in line


def test_launcher_trace_writes_chrome_json(tmp_path, capsys):
    path = tmp_path / "run.trace.json"
    tlaunch.main([*SMALL, "--device", "cpu", "--policies", "clustered",
                  "--trace", str(path), "--trace-summary"])
    out = capsys.readouterr().out
    with open(path) as f:
        doc = json.load(f)
    lanes = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"worker-0", "worker-1", "dispatcher-0", "driver"} <= lanes
    assert any(e.get("cat") == "task" for e in doc["traceEvents"])
    assert f"trace: wrote {path}" in out and "worker-0" in out


@pytest.mark.parametrize("flag", ["--mesh", "--hosts", "--stream",
                                  "--serve"])
def test_later_slice_flags_raise_not_implemented(flag):
    with pytest.raises(NotImplementedError, match="slice"):
        tlaunch.main([*SMALL, "--device", "cpu", flag, "2"])


def test_launcher_without_card_or_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(SMALL)


def test_module_entry_point_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fpm_mine", "--device",
         "cpu", "--dataset", "chess", "--max-k", "2", "--workers", "2",
         "--policies", "clustered", "--arena", "numpy"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert set(_policy_lines(proc.stdout)) == {"clustered"}
