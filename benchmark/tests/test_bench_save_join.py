"""``save_join_ms.train``: the mean ``save.join`` span of the saves wholly
inside the traced window, and nothing from a port that records none (one
that writes its saves on the main thread)."""

from __future__ import annotations

import threading
from collections import namedtuple

import pytest
from conftest import ROOT

from benchmark import harness, program_spans

Span = namedtuple("Span", "name start_ns end_ns thread id parent attrs")
MS = 1_000_000
MAIN = threading.main_thread().ident


def _facts():
    return {"trace": harness.Trace(1000 * MS, 11000 * MS, [("k", 1000 * MS, 2000 * MS, 1)], []),
            "block_least_s": 1.0}


def _save(start, join_ms, sid):
    return [Span("train.save", start * MS, (start + 50) * MS, MAIN, sid, 0, {"epoch": sid}),
            Span("save.join", start * MS, (start + join_ms) * MS, MAIN, sid + 100, sid,
                 {"waited": join_ms > 1})]


@pytest.mark.parametrize("spans,want", [
    # the first save lies before the window, the last straddles its end
    (_save(500, 30, 1) + _save(3000, 2, 2) + _save(6000, 4, 3) + _save(10990, 20, 4), 3.0),
    (_save(3000, 2, 2)[:1] + [Span("save.write", 3050 * MS, 3400 * MS, MAIN + 1, 9, 0, {})],
     None),
])
def test_save_join_reader(monkeypatch, spans, want):
    monkeypatch.setattr(program_spans, "recorded", lambda: list(spans))
    cell = harness.load_cell(ROOT, "train-s16-b128")
    got = harness.read_layer_metrics(cell, _facts())
    if want is None:
        assert "save_join_ms.train" not in got
    else:
        assert got["save_join_ms.train"] == {"value": pytest.approx(want), "unit": "ms"}
