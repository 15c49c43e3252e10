"""The port's launcher against the reference's: the same dataset and
policies give the same frequent-itemset counts (also with ``--hosts 2``,
two rank processes over a TCPStore, and ``--mesh 2``, two logical
shards), ``--trace`` writes a loadable Chrome trace, and without a card
the launcher refuses to start unless ``--device cpu`` is given."""
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


def _mesh_lines(out):
    """The ``mesh:`` line and each policy line's d2d and migration
    columns (occupancy per shard depends on thread timing)."""
    return (re.findall(r"^mesh: .*$", out, re.M),
            re.findall(r"^(\w+)\s+wall=.* (d2d=\d+B migrations=\d+) "
                       r"dev_occ=", out, re.M))


@pytest.mark.parametrize("flag", ["--mesh", "--hosts", "--stream",
                                  "--serve"])
def test_mesh_flags_match_reference_launcher(flag, monkeypatch, capsys):
    """--mesh, which raised before the multi-device slice, runs on the
    CPU: alone and with --stream (and --serve), its ``mesh:`` line, d2d
    and migration columns, stream rounds and served counts are the
    reference launcher's; --hosts with --mesh raises the reference's
    ValueError."""
    if flag == "--hosts":
        with pytest.raises(ValueError, match="mutually exclusive"):
            tlaunch.main([*SMALL, "--device", "cpu", "--hosts", "2",
                          "--mesh", "2"])
        return
    extra = {"--mesh": [], "--stream": ["--stream", "2"],
             "--serve": ["--stream", "2", "--serve", "4"]}[flag]
    args = [*SMALL, "--policies", "clustered", "--mesh", "2", *extra]
    monkeypatch.setattr(sys, "argv", ["fpm_mine", *args, "--backend",
                                      "numpy"])
    rlaunch.main()
    want = capsys.readouterr().out
    tlaunch.main([*args, "--device", "cpu"])
    got = capsys.readouterr().out
    assert _mesh_lines(got)[0] == _mesh_lines(want)[0] == [
        "mesh: 2 device shards (logical)"]
    if flag == "--mesh":
        assert _mesh_lines(got)[1] == _mesh_lines(want)[1] == [
            ("clustered", "d2d=0B migrations=0")]
        assert _serial_count(got) == _serial_count(want) > 0
    else:
        assert "stream final == serial" in got
        gens, first, serve = _stream_lines(got)
        assert (gens, first, serve) == _stream_lines(want)
        assert sorted(gens) == [2, 3] and first > 0
        assert (serve is None) == (flag == "--stream")


def _hosts_line(out):
    m = re.search(r"^(\w+)\s+hosts=(\d+) wall=.* frequent=(\d+) .* net=(\d+)B",
                  out, re.M)
    return m.group(1), int(m.group(2)), int(m.group(3)), int(m.group(4))


@pytest.mark.timeout(120)
def test_launcher_hosts_reproduce_reference_result_line(monkeypatch, capfd):
    """--hosts 2: the parent hosts a TCPStore and spawns two rank
    processes; rank 0's result line names the reference's policy, host
    count and frequent count (the reference's own --hosts run over
    jax.distributed), rank 0 checked it against ``mine_serial``, and
    each rank reported its kernel launches."""
    args = [*SMALL, "--hosts", "2"]
    monkeypatch.setattr(sys, "argv", ["fpm_mine", *args])
    rlaunch.main()          # its rank 0 writes to the inherited stdout
    want = capfd.readouterr().out
    tlaunch.main([*args, "--device", "cpu"])
    got = capfd.readouterr().out
    policy, hosts, frequent, net = _hosts_line(got)
    assert (policy, hosts, frequent) == _hosts_line(want)[:3]
    assert hosts == 2 and frequent > 0 and net > 0
    assert "equals mine_serial" in got
    launches = re.findall(r"^(rank 1: )?launches: (\{.*\})$", got, re.M)
    assert [r for r, _ in launches] == ["", "rank 1: "]
    assert all(set(json.loads(j)) == {"bitmap_join_many",
                                      "gather_intersect_many"}
               for _, j in launches)


def test_launcher_hosts_refuse_stream():
    with pytest.raises(SystemExit, match="mutually exclusive"):
        tlaunch.main([*SMALL, "--device", "cpu", "--hosts", "2",
                      "--stream", "2"])


STREAM_KEYS = ("reused", "delta", "full", "born", "died")


def _stream_lines(out):
    """{generation: {key: value}} of the stream rounds, the first
    generation's frequent count, and the serve stats line (None without
    --serve)."""
    gens = {}
    for m in re.finditer(r"^stream gen(\d+): \+\d+tx .*$", out, re.M):
        gens[int(m.group(1))] = {
            k: int(re.search(rf"\b{k}=(\d+)", m.group(0)).group(1))
            for k in STREAM_KEYS}
    first = int(re.search(r"^stream gen1: .*frequent=(\d+)", out,
                          re.M).group(1))
    serve = re.search(r"^serve stats: (.*)$", out, re.M)
    return gens, first, serve and serve.group(1)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_launcher_stream_and_serve_match_reference(monkeypatch, capsys,
                                                   backend):
    """--stream 2 --serve 4: the same rounds, border and reuse counts,
    final check against the serial miner, and served query counts and
    sweep bytes as the reference launcher's."""
    args = [*SMALL, "--stream", "2", "--serve", "4", "--policies",
            "clustered"]
    monkeypatch.setattr(sys, "argv", ["fpm_mine", *args, "--backend",
                                      "numpy"])
    rlaunch.main()
    want = capsys.readouterr().out
    tlaunch.main([*args, "--device", "cpu", "--backend", backend])
    got = capsys.readouterr().out
    assert "stream final == serial" in got
    gens, first, serve = _stream_lines(got)
    assert (gens, first, serve) == _stream_lines(want)
    assert sorted(gens) == [2, 3] and first > 0
    assert {re.search(r"^serve (\w+)\s*: n=\s*(\d+)", line).group(1)
            for line in got.splitlines()
            if re.match(r"^serve \w+\s*: n=", line)} == {
        "hit", "sweep", "top_k"}


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
