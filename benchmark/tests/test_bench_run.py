"""The command's refusals: no card, no program."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest
from conftest import ROOT

ARGS = ["--workload", "train-s16-b128", "--seed", "4294967311", "--seconds", "1", "--trace", "0"]


def _run(cwd, env_extra=None):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(cwd), "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder:
    non-zero, no line."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_traced_run_and_result_line():
    """A traced tiny run: the window's trace is read (no device events on
    the CPU, so the device readers find nothing and are left out), and the
    result line ends with the checks."""
    import json

    from conftest import tiny_run

    from benchmark import harness

    out = tiny_run("serve", seed=77, trace=True)
    tr = out["facts"]["trace"]
    assert tr.window_s > 0 and tr.device == [] and any(n == "request" for n, _, _ in tr.host)
    cell = harness.load_cell(ROOT, "serve-s8-c25")
    metrics = harness.read_layer_metrics(cell, out["facts"])
    assert set(metrics) == {"mfu.dense"}
    checks = harness.judge(out["numbers"], harness.load_limits(cell))
    line = harness.result_line(True, out["attempted"], 0, metrics, {"platform": "gpu"}, checks,
                               tr.breakdown())
    assert list(json.loads(line)) == ["correct", "attempted", "failed", "metrics", "device",
                                      "breakdown", "checks"]


@pytest.mark.cuda
def test_control_at_the_cells_size(card):
    """The control on the card at the train cell's own size on three seeds
    (run by ``benchmark/readings.py --mode control`` as well)."""
    from benchmark import harness
    from benchmark.readings import readings

    cell = harness.load_cell(ROOT, "train-s16-b128")
    limits = harness.load_limits(cell)
    for row in readings(cell, [31, 32, 33], "control", 1.0, card):
        nums = {k: row[k] for k in limits}
        assert not all(c["ok"] for c in harness.judge(nums, limits).values())


def test_train_readers_on_a_tiny_run():
    """The train cell's host-span readers on a tiny CPU run: the stall share
    and the rate outside the stalls read the run's own spans, and the rate
    outside the stalls is at least the window's rate."""
    from conftest import tiny_run

    from benchmark import harness

    out = tiny_run("train", seed=55, seconds=1.0)
    facts = out["facts"]
    cell = harness.load_cell(ROOT, "train-s16-b128")
    metrics = harness.read_layer_metrics(cell, facts)
    assert {"driver_stall_share.train", "step_clips_per_s.train", "mfu.train"} <= set(metrics)
    assert facts["clips"] == out["attempted"]
    rate = out["e2e"]["train_clips_per_s"]
    assert metrics["step_clips_per_s.train"]["value"] >= rate > 0
    assert 0 <= metrics["driver_stall_share.train"]["value"] < 100
