#!/usr/bin/env python3
"""Host cost of one ``obs/profiling.annotate`` span, recording off and on.

    python tools/time_spans.py [--n 100000] [--rounds 5]

Off: no profiler runs; a span is one check and a shared no-op context. On:
inside ``torch.profiler.profile`` (CPU activity); a span is kept in memory and
opened as a ``record_function``. Prints one JSON line: microseconds a span,
the best of ``--rounds`` rounds of ``--n`` spans each, less the empty loop's
own time, with the host's architecture and CPU count beside them.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time
from pathlib import Path

from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from timetuning_tpu_torch.obs import profiling  # noqa: E402


def per_span_us(n: int, rounds: int, body) -> float:
    best = float("inf")
    for _ in range(rounds):
        profiling.clear()
        t0 = time.perf_counter()
        body(n)
        best = min(best, (time.perf_counter() - t0) / n)
    return best * 1e6


def spans(n: int) -> None:
    for i in range(n):
        with profiling.annotate("loader.stage"):
            pass


def spans_with_attrs(n: int) -> None:
    for i in range(n):
        with profiling.annotate("loader.decode", epoch=1, batch=i):
            pass


def empty(n: int) -> None:
    for i in range(n):
        pass


def main() -> None:
    p = argparse.ArgumentParser("tools/time_spans.py")
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--rounds", type=int, default=5)
    args = p.parse_args()
    loop = per_span_us(args.n, args.rounds, empty)
    out = {"n": args.n, "rounds": args.rounds, "machine": platform.machine(),
           "cpus": os.cpu_count(), "loop_us": loop,
           "off_us": per_span_us(args.n, args.rounds, spans) - loop,
           "off_attrs_us": per_span_us(args.n, args.rounds, spans_with_attrs) - loop}
    with profile(activities=[ProfilerActivity.CPU]):
        out["on_us"] = per_span_us(args.n, args.rounds, spans) - loop
        out["on_attrs_us"] = per_span_us(args.n, args.rounds, spans_with_attrs) - loop
    profiling.clear()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
