"""The port's own spans over a traced window, for the per-layer readers.

The port records a span of its own work (``timetuning_tpu_torch/obs/
profiling.annotate``: the training driver's epochs, steps, loss reads and
saves, the loader's waits, stagings and decodes, a graph's replays, the
serving program's calls) while a ``torch.profiler`` session runs, which a
``--trace 1`` window is, and keeps it in memory (``profiling.spans()``) in
ns on the trace's own clock. Here they are clipped to the window
``[facts["trace"].lo, facts["trace"].hi]``, measured whole, reduced to self
time, and laid over the device's idle stretches (the complement of the
union of ``facts["trace"].device``), each put down to the innermost span
the main thread had open at that moment.

A port without the recorder (one older than it), a run without a trace or
a trace with no device event (a run off the card) gives None, and the
readers leave their metric out.

    python3 benchmark/program_spans.py --workload <cell> --seed <n> --seconds <s> --trace 1

runs one traced run of a cell as ``benchmark/run.py`` does, and then prints
on standard error a line ``idle_by_span {...}``: the card's idle seconds by
innermost main-thread span (``none``: no span open).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import threading
from pathlib import Path

NONE = "none"


def recorded():
    """The port's spans, or None where its profiling module keeps none."""
    try:
        from timetuning_tpu_torch.obs import profiling
    except ImportError:
        return None
    get = getattr(profiling, "spans", None)
    return None if get is None else list(get())


@dataclasses.dataclass
class Window:
    """The spans that overlap a traced window, and the window."""

    lo: int
    hi: int
    spans: list                 # the port's records, unclipped
    device: list                # the trace's device events, (name, start, end, corr)
    main: int                   # the main thread's ident

    def clipped(self, s) -> tuple[int, int]:
        return max(s.start_ns, self.lo), min(s.end_ns, self.hi)

    def whole(self, name: str) -> list:
        """The spans of ``name`` that lie wholly inside the window."""
        return [s for s in self.spans
                if s.name == name and s.start_ns >= self.lo and s.end_ns <= self.hi]


def window(facts: dict) -> Window | None:
    """The port's spans over the run's traced window; None without a trace
    that kept a device event (a run off the card) or without the port's
    spans."""
    tr = facts.get("trace")
    if tr is None or not tr.device:
        return None
    spans = recorded()
    if spans is None:
        return None
    inside = [s for s in spans if s.end_ns > tr.lo and s.start_ns < tr.hi]
    return Window(tr.lo, tr.hi, inside, tr.device, threading.main_thread().ident)


def mean_ms(facts: dict, name: str) -> float | None:
    """Mean milliseconds of the spans of ``name`` wholly inside the window
    (on any thread); None where there are none."""
    w = window(facts)
    if w is None:
        return None
    got = w.whole(name)
    if not got:
        return None
    return sum(s.end_ns - s.start_ns for s in got) / len(got) / 1e6


def self_ns(w: Window) -> dict:
    """Each span name's self time inside the window: its clipped length less
    the clipped lengths of its children."""
    out: dict = {}
    by_id = {s.id: s for s in w.spans}
    for s in w.spans:
        a, b = w.clipped(s)
        out[s.name] = out.get(s.name, 0) + (b - a)
        p = by_id.get(s.parent)
        if p is not None:
            out[p.name] = out.get(p.name, 0) - (b - a)
    return out


def idle_intervals(w: Window) -> list:
    """The stretches of the window with no device event."""
    gaps, end = [], w.lo
    for _, a, b, _ in sorted(w.device, key=lambda e: e[1]):
        if a > end:
            gaps.append((end, min(a, w.hi)))
        end = max(end, b)
    if w.hi > end:
        gaps.append((end, w.hi))
    return [(a, b) for a, b in gaps if b > a]


def innermost(w: Window) -> list:
    """The window cut into (start, end, name) pieces by the innermost span
    the main thread had open (``none`` where it had none); a thread's spans
    nest, so a stack sweep over them by start finds it."""
    main = sorted((s for s in w.spans if s.thread == w.main),
                  key=lambda s: (s.start_ns, -s.end_ns))
    pieces, stack, cursor = [], [], w.lo

    def cut(to: int, name: str) -> None:
        nonlocal cursor
        if to > cursor:
            pieces.append((cursor, to, name))
            cursor = to

    for s in main:
        a, b = w.clipped(s)
        while stack and stack[-1][1] <= a:
            _, end, name = stack.pop()
            cut(end, name)
        cut(a, stack[-1][2] if stack else NONE)
        stack.append((a, b, s.name))
    while stack:
        _, end, name = stack.pop()
        cut(end, name)
    cut(w.hi, NONE)
    return pieces


def idle_by_span(w: Window) -> dict:
    """The device's idle ns by the innermost main-thread span open at the
    time."""
    out: dict = {}
    gaps, pieces = idle_intervals(w), innermost(w)
    i = 0
    for a, b, name in pieces:
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            o = min(b, gaps[j][1]) - max(a, gaps[j][0])
            if o > 0:
                out[name] = out.get(name, 0) + o
            j += 1
    return out


def idle_share(facts: dict, names) -> float | None:
    """Percent of the window in which the card was idle while the main
    thread's innermost span was one of ``names``."""
    w = window(facts)
    if w is None:
        return None
    idle = idle_by_span(w)
    return 100.0 * sum(idle.get(n, 0) for n in names) / (w.hi - w.lo)


def idle_seconds(facts: dict) -> dict | None:
    """The window, the card's idle seconds in it, and those seconds by
    innermost main-thread span (with ``train.epoch``'s own share beside
    its self time)."""
    w = window(facts)
    if w is None:
        return None
    by = sorted(idle_by_span(w).items(), key=lambda kv: -kv[1])
    selfs = self_ns(w)
    return {"window_s": (w.hi - w.lo) / 1e9,
            "idle_s": sum(b - a for a, b in idle_intervals(w)) / 1e9,
            "by_span": {n: v / 1e9 for n, v in by},
            "self_s": {n: v / 1e9 for n, v in sorted(selfs.items(), key=lambda kv: -kv[1])}}


def main(argv=None) -> int:
    """One run of ``benchmark/run.py`` in this process, and its idle
    seconds by span where it was traced."""
    root = Path(__file__).resolve().parent.parent
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from benchmark import harness, run

    kept = {}
    read = harness.read_layer_metrics

    def keep(cell, facts):
        kept["facts"] = facts
        return read(cell, facts)

    harness.read_layer_metrics = keep
    try:
        rc = run.main(argv)
    finally:
        harness.read_layer_metrics = read
    if rc == 0 and "facts" in kept:
        print("idle_by_span " + json.dumps(idle_seconds(kept["facts"])),
              file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
