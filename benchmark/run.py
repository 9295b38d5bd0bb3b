#!/usr/bin/env python3
"""The benchmark of timetuning_tpu_torch: one cell, one run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. Loads and warms up (set-up), measures for ``--seconds``, checks what
the timed path produced against the plain reference under
``benchmark/reference``, and prints one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and,
last, ``checks`` (each compared number with its limit). Exits non-zero and
prints no line when there is no card, when the program is missing, or when
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


class Run:
    """One run of a cell as its driver sees it: the cell, the seed, the
    window's length, whether it is traced, the host spans, and the window's
    opening and closing (with the profiler around it when traced)."""

    def __init__(self, cell: harness.Cell, seed: int, seconds: float, trace: bool,
                 device, setup_t0: float, work_dir: str):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.setup_t0, self.work_dir = device, setup_t0, work_dir
        self.spans = harness.Spans(trace)
        self.mode = None        # the control and fault checks set it; never a benchmark run
        self.lo = self.hi = None
        self._prof = self._mark = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def open_window(self) -> float:
        """Set-up ends here; the measured window starts."""
        if self.trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._mark = record_function("bench.window")
            self._mark.__enter__()
        self.sync()
        self.lo = time.perf_counter()
        return self.lo

    def close_window(self) -> float:
        self.sync()
        self.hi = time.perf_counter()
        if self.trace:
            self._mark.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
        return self.hi

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def setup_s(self) -> float:
        return self.lo - self.setup_t0

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def trace_facts(self) -> harness.Trace | None:
        if not self.trace:
            return None
        return harness.reduce_profile(self._prof)


def parse(argv=None):
    p = argparse.ArgumentParser("benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    setup_t0 = time.perf_counter() - harness.process_age_s()
    args = parse(argv)
    cell = harness.load_cell(ROOT, args.workload)
    harness.set_cache_dirs(ROOT)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    driver = harness.load_driver(cell)
    with tempfile.TemporaryDirectory(prefix="bench_") as work_dir:
        run = Run(cell, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0), setup_t0, work_dir)
        out = driver.run(run)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    limits = harness.load_limits(cell)
    checks = harness.judge(out["numbers"], limits)
    correct = out["correct"] and all(c["ok"] for c in checks.values())
    if args.trace:
        metrics = harness.read_layer_metrics(cell, out["facts"])
    else:
        metrics = {m["name"]: {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = out["device"]
    breakdown = None
    if args.trace:
        tr = out["facts"]["trace"]
        device = {**device, "busy_s": tr.busy_s(), "window_s": tr.window_s}
        breakdown = tr.breakdown()
    line = harness.result_line(correct, out["attempted"], out["failed"], metrics,
                               device, checks, breakdown)
    print(line, flush=True)
    print(harness.fact_line(out["facts"]), file=sys.stderr, flush=True)
    print(harness.check_lines(checks), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
