"""Profiling hooks: a device trace around a block, and the program's spans.

Counterpart of ``timetuning_tpu/obs/profiling.py`` (``jax.profiler``
there): ``torch.profiler`` with the CPU and, where there is a card, the CUDA
activities, written as a Chrome trace that TensorBoard and Perfetto read.

``annotate(name, **attrs)`` marks a span of the program's own work: the
training driver's epochs, steps, loss reads and saves, the loader's waits,
stagings and decodes, a CUDA graph's replays. Recording is on while a
``torch.profiler`` session is active (``trace`` runs one) and off
otherwise. Off, a span is one check and a shared no-op context. On, it is
kept in memory (``spans()``) and opened as a ``record_function`` of the same
name, so that it shows in the device trace (the profiler traces the thread
that started it; ``spans()`` holds every thread's).

A span's start and end are ns on the profiler's timebase, the wall clock
since the epoch: the monotonic ``perf_counter_ns`` plus one offset to
``time.time_ns``, taken when recording resumes after a pause of a second or
more, so that spans stay in order while they fall where the trace's events
fall.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import NamedTuple

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

# records kept; later spans are counted in ``dropped()`` and not kept
CAPACITY = 1 << 20
# a pause in recording after which the offset to the wall clock is re-taken
_PAUSE_NS = 1_000_000_000


class Span(NamedTuple):
    """One recorded span: ``start_ns`` / ``end_ns`` on the profiler's
    timebase, the thread's ident, its own id and its parent's (0 for none:
    the span open on the same thread when it began)."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: int
    attrs: dict


class Recorder:
    """The process's spans: a bounded buffer, each thread's stack of open
    spans, and the offset from ``perf_counter_ns`` to the wall clock."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._local = threading.local()
        self._records: list[Span] = []
        self._dropped = 0
        self._next_id = 1
        self._offset = 0
        self._last_ns = None

    def _open(self) -> tuple[int, int, int]:
        """(id, parent, offset) of a span beginning on this thread."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        now = time.perf_counter_ns()
        with self._lock:
            if self._last_ns is None or now - self._last_ns > _PAUSE_NS:
                self._offset = time.time_ns() - time.perf_counter_ns()
            self._last_ns = now
            sid = self._next_id
            self._next_id += 1
            offset = self._offset
        parent = stack[-1] if stack else 0
        stack.append(sid)
        return sid, parent, offset

    def _close(self, span: Span) -> None:
        self._local.stack.pop()
        with self._lock:
            if len(self._records) < self.capacity:
                self._records.append(span)
            else:
                self._dropped += 1

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._records)

    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._records = []
            self._dropped = 0


class _Off:
    """The one context of every span while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_RECORDER = Recorder()
_OFF = _Off()


class _Recorded:
    """A span while recording is on: its record and its ``record_function``."""

    __slots__ = ("name", "attrs", "_id", "_parent", "_offset", "_start", "_fn")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self._id, self._parent, self._offset = _RECORDER._open()
        self._fn = record_function(self.name)
        self._fn.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._fn.__exit__(*exc)
        _RECORDER._close(Span(self.name, self._start + self._offset, end + self._offset,
                              threading.get_ident(), self._id, self._parent, self.attrs))
        return False


def annotate(name: str, **attrs):
    """A named span of the program's work (``attrs``: a few small values
    such as the epoch or the batch), recorded while a profiler runs: the
    profiler module's flag, which every thread sees."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recorded(name, attrs)


def spans() -> list[Span]:
    """The spans recorded so far, in the order they ended."""
    return _RECORDER.spans()


def dropped() -> int:
    """Spans not kept since the last ``clear()``: the buffer was full."""
    return _RECORDER.dropped()


def clear() -> None:
    """Empty the buffer of spans."""
    _RECORDER.clear()


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Capture a trace of the block into ``log_dir/trace.json``, and the
    program's spans recorded inside it into ``log_dir/spans.jsonl``."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.jsonl"), "w") as f:
        for s in spans():
            if s.start_ns >= t0:
                f.write(json.dumps(s._asdict()) + "\n")
