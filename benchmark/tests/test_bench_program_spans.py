"""The readers of the port's own spans (``benchmark/program_spans.py`` and
the six ``program_span`` metrics that read it) on synthetic spans and device
events, on a tiny traced run's real spans, and on a port without the
recorder."""

from __future__ import annotations

import threading
from collections import namedtuple

import pytest
from conftest import ROOT, tiny_run

from benchmark import harness, program_spans

Span = namedtuple("Span", "name start_ns end_ns thread id parent attrs")
MS = 1_000_000
MAIN = threading.main_thread().ident
SIDE = MAIN + 1

TRAIN = ("idle_loader_share.train", "stage_ms.train", "decode_ms.train",
         "checkpoint_gather_ms.train", "step_host_ms.train")


def _span(name, a, b, sid, parent=0, thread=MAIN):
    return Span(name, a * MS, b * MS, thread, sid, parent, {})


# a window of [1000, 11000] ms; the epoch straddles both edges, a staging
# the closing one, another lies before the window, a decode runs on a side
# thread
SPANS = [
    _span("loader.stage", 100, 400, 9),
    _span("loader.wait", 2000, 3000, 2, 1),
    _span("loader.stage", 3000, 3500, 3, 1),
    _span("graph.replay", 4500, 5000, 5, 4),
    _span("train.step", 4000, 6000, 4, 1),
    _span("save.gather", 7000, 8000, 7, 6),
    _span("save.write", 8000, 9000, 8, 6),
    _span("train.save", 7000, 9000, 6, 1),
    _span("loader.stage", 10500, 11500, 10, 1),
    _span("train.epoch", 500, 12000, 1),
    _span("loader.decode", 1500, 4000, 11, thread=SIDE),
]
# busy [1000, 2500], [4200, 7500], [8500, 10000]: idle [2500, 4200],
# [7500, 8500], [10000, 11000]
DEVICE = [("k", 1000 * MS, 2500 * MS, 1), ("k", 4200 * MS, 6000 * MS, 2),
          ("k", 5000 * MS, 7500 * MS, 3), ("k", 8500 * MS, 10000 * MS, 4)]


def _facts(device=DEVICE):
    # block_least_s: read by the cells' roofline readers, which find no block kernel here
    return {"trace": harness.Trace(1000 * MS, 11000 * MS, list(device), []),
            "block_least_s": 1.0}


@pytest.fixture
def synthetic(monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", lambda: list(SPANS))


def test_idle_by_innermost_main_thread_span(synthetic):
    w = program_spans.window(_facts())
    idle = {k: v / MS for k, v in program_spans.idle_by_span(w).items()}
    assert idle == {"loader.wait": 500, "loader.stage": 1000, "train.epoch": 1000,
                    "train.step": 200, "save.gather": 500, "save.write": 500}
    assert sum(idle.values()) * MS == sum(b - a for a, b in program_spans.idle_intervals(w))
    selfs = {k: v / MS for k, v in program_spans.self_ns(w).items()}
    # the epoch clipped to the window, less its children (the edge staging clipped)
    assert selfs["train.epoch"] == 10000 - 1000 - 500 - 500 - 2000 - 2000
    assert selfs["train.step"] == 1500 and selfs["train.save"] == 0
    assert selfs["loader.decode"] == 2500 and "graph.replay" in selfs
    table = program_spans.idle_seconds(_facts())
    assert table["idle_s"] == pytest.approx(3.7) and table["window_s"] == pytest.approx(10.0)
    assert list(table["by_span"])[:2] in (["loader.stage", "train.epoch"],
                                          ["train.epoch", "loader.stage"])


def test_no_span_open_is_none(monkeypatch):
    monkeypatch.setattr(program_spans, "recorded",
                        lambda: [_span("train.step", 3000, 4000, 1)])
    idle = program_spans.idle_by_span(program_spans.window(_facts()))
    assert {k: v / MS for k, v in idle.items()} == {"none": 2700, "train.step": 1000}


def test_the_six_readers(synthetic, monkeypatch):
    cell = harness.load_cell(ROOT, "train-s16-b128")
    got = {k: v["value"] for k, v in harness.read_layer_metrics(cell, _facts()).items()}
    # means over the spans wholly inside the window only
    want = {"idle_loader_share.train": 15.0, "stage_ms.train": 500.0,
            "decode_ms.train": 2500.0, "checkpoint_gather_ms.train": 1000.0,
            "step_host_ms.train": 2000.0}
    assert {k: got[k] for k in TRAIN} == pytest.approx(want)
    serve = harness.load_cell(ROOT, "serve-s8-c25")
    assert "call_host_ms.serve" not in harness.read_layer_metrics(serve, _facts())
    calls = [_span("serve.call", 1000 + 30 * i, 1004 + 30 * i, i + 1) for i in range(5)]
    monkeypatch.setattr(program_spans, "recorded", lambda: calls)
    got = harness.read_layer_metrics(serve, _facts())
    assert got["call_host_ms.serve"] == {"value": pytest.approx(4.0), "unit": "ms"}


def _readers():
    return {name: harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", name)
            for name in TRAIN + ("call_host_ms.serve",)}


def test_none_without_the_recorder_or_a_card_trace(monkeypatch, synthetic):
    readers = _readers()
    # no trace, or a trace that kept no device event (a run on the CPU)
    for facts in ({"trace": None}, {}, _facts(device=[])):
        assert all(r.read(facts) is None for r in readers.values())
    # a port whose profiling module keeps no spans
    monkeypatch.undo()
    from timetuning_tpu_torch.obs import profiling

    monkeypatch.delattr(profiling, "spans")
    assert program_spans.recorded() is None
    assert all(r.read(_facts()) is None for r in readers.values())


def test_a_tiny_traced_run_gives_the_train_readers_its_spans():
    """The port's real spans of a tiny traced run on the CPU, over device
    events planted in its trace (the CPU has none): the idle time is spread
    over the spans in full, and each train reader reads the mean of the
    spans that lie wholly inside the window (a span a step or more long may
    have none in a short window)."""
    out = tiny_run("train", seed=61, seconds=1.5, trace=True)
    facts = out["facts"]
    tr = facts["trace"]
    assert tr.device == []
    mid = (tr.lo + tr.hi) // 2
    tr.device.append(("planted", tr.lo, mid, 0))
    w = program_spans.window(facts)
    names = {s.name for s in w.spans}
    assert {"train.epoch", "train.step", "loader.stage", "loader.decode", "train.log",
            "train.loss_read", "train.save", "save.gather", "save.write"} <= names
    idle = program_spans.idle_by_span(w)
    assert sum(idle.values()) == tr.hi - mid
    cell = harness.load_cell(ROOT, "train-s16-b128")
    got = harness.read_layer_metrics(cell, facts)
    assert 0 <= got["idle_loader_share.train"]["value"] <= 50
    spans = {"stage_ms.train": "loader.stage", "decode_ms.train": "loader.decode",
             "checkpoint_gather_ms.train": "save.gather", "step_host_ms.train": "train.step"}
    # a staging follows the step that opens the window, wholly inside it
    assert w.whole("loader.stage")
    for metric, name in spans.items():
        whole = w.whole(name)
        if whole:
            mean = sum(s.end_ns - s.start_ns for s in whole) / len(whole) / 1e6
            assert got[metric]["value"] == pytest.approx(mean) and mean > 0
        else:
            assert metric not in got
