"""The port's span recorder (``timetuning_tpu_torch/obs/profiling.py``).

On the CPU: off, a span records nothing and opens no ``record_function``;
under ``torch.profiler.profile`` spans are kept with their nesting, parents,
attrs and threads, and fall within 100 us of their own kineto events; the
buffer is bounded; ``trace`` writes ``spans.jsonl`` beside ``trace.json``.

On the card (marker ``cuda``, skipped here; ``python -m pytest --noconftest
-m cuda tests/test_torch_profiling.py``): ``CapturedCall``'s spans, and a span
around a synchronise against the kernel it waited for in the device trace.
"""

import json
import threading

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from timetuning_tpu_torch.obs import profiling


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def _kineto(prof, name, device=DeviceType.CPU):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name() == name and e.device_type() == device]


def test_off_records_nothing_and_opens_no_record_function(monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: opened.append(name))
    assert not autograd_profiler._is_profiler_enabled
    with profiling.annotate("a", epoch=1):
        with profiling.annotate("b"):
            pass
    assert profiling.annotate("a") is profiling.annotate("b")   # one shared context
    assert profiling.spans() == [] and opened == []


def test_profiler_flag_is_seen_by_every_thread():
    seen = []

    def look():
        seen.append(autograd_profiler._is_profiler_enabled)

    with profile(activities=[ProfilerActivity.CPU]):
        t = threading.Thread(target=look)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    look()
    assert seen == [True, False]


def test_spans_nest_with_parents_attrs_and_threads():
    other = {}

    def worker():
        other["ident"] = threading.get_ident()
        with profiling.annotate("side", batch=3):
            with profiling.annotate("side.inner"):
                pass

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("outer", epoch=2):
            with profiling.annotate("inner"):
                torch.ones(8).sum()
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with profiling.annotate("inner"):
                pass
    by_name = {}
    for s in profiling.spans():
        by_name.setdefault(s.name, []).append(s)
    (outer,) = by_name["outer"]
    assert outer.parent == 0 and outer.attrs == {"epoch": 2}
    assert len(by_name["inner"]) == 2
    for s in by_name["inner"]:
        assert s.parent == outer.id and s.thread == outer.thread == threading.get_ident()
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    a, b = sorted(by_name["inner"], key=lambda s: s.start_ns)
    assert a.end_ns <= b.start_ns
    (side,) = by_name["side"]
    (side_inner,) = by_name["side.inner"]
    # the other thread's stack is its own: no parent from the main thread
    assert side.thread == side_inner.thread == other["ident"] != outer.thread
    assert side.parent == 0 and side_inner.parent == side.id and side.attrs == {"batch": 3}
    # each span is also a record_function of the same name (on the profiled thread)
    assert len(_kineto(prof, "outer")) == 1 and len(_kineto(prof, "inner")) == 2
    assert len({s.id for s in profiling.spans()}) == len(profiling.spans())


def test_spans_are_on_the_trace_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("warm"):
            pass
        with profiling.annotate("timed"):
            torch.ones(64).sum()
    (span,) = [s for s in profiling.spans() if s.name == "timed"]
    (event,) = _kineto(prof, "timed")
    assert abs(span.start_ns - event.start_ns()) < 100_000
    assert abs(span.end_ns - event.end_ns()) < 100_000


def test_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "_RECORDER", profiling.Recorder(capacity=2))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(3):
            with profiling.annotate("s", i=i):
                pass
    assert [s.attrs["i"] for s in profiling.spans()] == [0, 1]
    assert profiling.dropped() == 1
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_trace_writes_the_spans_beside_the_trace(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("before"):
            pass
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("step", step=7):
            with profiling.annotate("step.part"):
                pass
    lines = [json.loads(x) for x in open(tmp_path / "spans.jsonl")]
    assert [x["name"] for x in lines] == ["step.part", "step"]
    assert lines[1]["attrs"] == {"step": 7} and lines[0]["parent"] == lines[1]["id"]
    part, step = lines
    assert step["start_ns"] <= part["start_ns"] <= part["end_ns"] <= step["end_ns"]
    assert (tmp_path / "trace.json").stat().st_size > 0


# ------------------------------------------------------------------ #
# on the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_call_spans(dev):
    from timetuning_tpu_torch.runtime import CapturedCall

    call = CapturedCall(lambda x: (x * 2 + 1).sum(0))
    x = torch.arange(12.0, device=dev).reshape(3, 4)
    want = (x * 2 + 1).sum(0)
    names = []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):
            profiling.clear()
            out = call(x)
            torch.cuda.synchronize()
            assert torch.equal(out, want)
            names.append([s.name for s in profiling.spans()])
    assert names == [["graph.eager"], ["graph.capture", "graph.replay"],
                     ["graph.replay"], ["graph.replay"]]


@pytest.mark.cuda
def test_a_span_around_a_synchronise_ends_with_the_kernel(dev):
    cycles = 10_000_000              # ~5 ms of torch.cuda._sleep at the H100's ~2 GHz
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(cycles // 10)
        with profiling.annotate("warm"):
            torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        with profiling.annotate("wait"):
            torch.cuda.synchronize()
    (span,) = [s for s in profiling.spans() if s.name == "wait"]
    device = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    kernel = max(device, key=lambda e: e.end_ns() - e.start_ns())
    assert kernel.end_ns() - kernel.start_ns() > 2_000_000      # the ~5 ms sleep
    assert kernel.end_ns() <= span.end_ns < kernel.end_ns() + 1_000_000
