"""The comparison has to fail a broken timed path and the control. Each
test drives the rest of a run (the tiny cell on the CPU, no look for a
card) with a fault planted under the timed path, and sees ``correct`` come
out false under the cell's own limits: the train step leaving its state
unchanged, the train step on half of each batch (its mean over the rest),
the ranks' gradient exchange left out, a served answer with one token
altered; and the control, the reference in fp8 in the program's place."""

from __future__ import annotations

import pytest
from conftest import ROOT, tiny_run

from benchmark import harness


def _correct(cell: str, numbers: dict) -> bool:
    """Judged under the limits file of ``cell`` (``limits/<cell>.json``),
    also for a cell that ``BENCHMARK.json`` does not list yet."""
    limits = harness.load_json(ROOT / "benchmark" / "limits" / f"{cell}.json")["limits"]
    return all(c["ok"] for c in harness.judge(numbers, limits).values())


@pytest.mark.parametrize("mode", ["fault:unchanged", "fault:half", "control"])
def test_train_faults_fail(mode):
    sound = tiny_run("train", seed=101)["numbers"]
    assert _correct("train-s16-b128", sound)
    broken = tiny_run("train", seed=101, mode=mode)["numbers"]
    assert not _correct("train-s16-b128", broken), broken


@pytest.mark.parametrize("mode", ["fault:exchange", "fault:half", "control"])
def test_data_parallel_faults_fail(mode):
    """Two gloo ranks on the CPU: the gradients' exchange left out, half of
    each batch, the control."""
    broken = tiny_run("train_dp", seed=303, mode=mode, seconds=1.0)["numbers"]
    assert not _correct("train-s16-dp4", broken), broken


def test_unchanged_state_reads_one():
    n = tiny_run("train", seed=5, mode="fault:unchanged")["numbers"]
    assert n["change_norm_gap"] == pytest.approx(1.0)
    assert n["grad_norm_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("mode", ["fault:altered", "control"])
def test_serve_faults_fail(mode):
    assert _correct("serve-s8-c25", tiny_run("serve", seed=202)["numbers"])
    broken = tiny_run("serve", seed=202, mode=mode)["numbers"]
    assert not _correct("serve-s8-c25", broken), broken
