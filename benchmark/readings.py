#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, several seeds in one
process: the program as it runs (``--mode program``), the reference in fp8
in its place (``--mode control``), or a fault planted under the timed path
(``--mode fault:half``, ``fault:unchanged``, ``fault:altered``).

    python3 benchmark/readings.py --workload <name> --mode control --seeds 11,12,13

Prints one JSON line a seed: the compared numbers. A short window
(``--seconds``, default 2) serves: the cells' numbers come from their
set-up steps or from requests sampled in the window. Not a benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.run import Run  # noqa: E402


def readings(cell: harness.Cell, seeds, mode: str, seconds: float, device) -> list:
    import torch

    driver = harness.load_driver(cell)
    out = []
    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix="bench_") as work_dir:
            run = Run(cell, seed, seconds, False, device, time.perf_counter(), work_dir)
            run.mode = None if mode == "program" else mode
            res = driver.run(run)
        row = {"seed": seed, "mode": mode, **res["numbers"]}
        if "readings" in res:
            row["readings"] = res["readings"]
        out.append(row)
        print(json.dumps(row), flush=True)
        del res
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("benchmark/readings.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", default="program")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    harness.set_cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    readings(cell, [int(s) for s in args.seeds.split(",")], args.mode, args.seconds,
             torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
