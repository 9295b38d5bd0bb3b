#!/usr/bin/env python3
"""Device times of the eval preprocess (K4) and the Sinkhorn kernel (K11) at
the main paths' shapes, and their split into phases, for one or several
copies of the kernel sources, in turns inside one process on one card.

    python tools/time_small_kernels.py [--split] [--shapes pre224,sk6272,...] [csrc_dir ...]

Shapes (``SHAPES``): ``pre224`` / ``pre448`` K4 on 50 uint8 frames of
480x854 (the eval group of two 25-frame DAVIS clips) resized to 224 (ViT-S/16)
and to 448 (ViT-S/8); ``sk6272`` / ``sk25088`` / ``sk22656`` K11 over [200, B]
(the score matrices of a 32- and a 128-clip train step and of a 32-clip step
with its queue full), 10 iterations, through ``sinkhorn_cuda``; ``asg6272`` /
``asg25088`` the step's own entry, ``sinkhorn_assignment_cuda`` on [B, 200] scores,
where the package has it. Each line gives the wrapper's time (CUDA events over
20 calls queued behind a device-side sleep, ``chip_smoke.cuda_ms``; and the
median of 10 calls each alone between two synchronises) and the
device time of each kernel by name (``torch.profiler``): the launches seen a
call (the profiler drops some events) and the time a launch;
each Sinkhorn shape also prints the matvec form's time (``ops/sinkhorn.
sinkhorn``, plain torch) once, and the kernel's plan on this card.

``--split``: each source is also built with ``-DTT_PRE_PHASES=p`` and
``-DTT_SINK_PHASES=p`` for p = 1, 2, 3; the full kernels are phase 4. What
each phase keeps is written at the macro in each source (``preprocess.cu``,
``sinkhorn.cu``): for K4 the loads alone, then each pass in turn, then the
stores; for K11 the load and the store, then the cross-block barriers, then
the partial sums between blocks, then the passes over the slab.

Without a directory: the package's own ``timetuning_tpu_torch/csrc``. To
compare with another commit, run this file from an unpacked copy of that
commit (the wrappers' Python signatures are the same). Needs a CUDA card and
nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from time_propagation import kernel_times  # noqa: E402
from timetuning_tpu_torch.data.transforms import IMAGENET_MEAN, REFERENCE_STD  # noqa: E402
from timetuning_tpu_torch.ops import kernel_lib  # noqa: E402
from timetuning_tpu_torch.ops import preprocess_cuda as pc  # noqa: E402
from timetuning_tpu_torch.ops import sinkhorn as skm  # noqa: E402
from timetuning_tpu_torch.ops import sinkhorn_cuda as sk  # noqa: E402

# name: ("pre", output size) or ("sk" / "asg", columns)
SHAPES = {
    "pre224": ("pre", 224), "pre448": ("pre", 448),
    "sk6272": ("sk", 6272), "sk25088": ("sk", 25088), "sk22656": ("sk", 22656),
    "asg6272": ("asg", 6272), "asg25088": ("asg", 25088),
}


def inputs(dev, name):
    kind, n = SHAPES[name]
    rng = np.random.default_rng(n)
    if kind == "pre":
        frames = torch.from_numpy(rng.integers(0, 256, (50, 480, 854, 3),
                                               dtype=np.uint8)).to(dev)
        return lambda: pc.eval_preprocess_cuda(frames, n, IMAGENET_MEAN, REFERENCE_STD)
    scores = torch.from_numpy(rng.uniform(-1, 1, (n, 200)).astype(np.float32)).to(dev)
    if kind == "asg":
        if not hasattr(sk, "sinkhorn_assignment_cuda"):
            return None
        return lambda: sk.sinkhorn_assignment_cuda(scores, 0.05, 10)
    Q = torch.exp(scores / 0.05).t().contiguous()
    ms = cs.cuda_ms(lambda: skm.sinkhorn(Q, 10))
    plan = (" | the kernel's plan %s, %d clusters of 8 resident" % sk.device_plan(200, n)
            if hasattr(sk, "device_plan") else "")
    print(f"{name}: the matvec form (plain torch) {ms:.4f} ms{plan}", flush=True)
    return lambda: sk.sinkhorn_cuda(Q, 10)


def isolated_ms(fn, reps: int = 10) -> float:
    """Median device time of one call alone: CUDA events around a single
    call after a synchronise."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        out.append(ev[0].elapsed_time(ev[1]))
    return float(np.median(out))


def measure(label, calls: dict, phase: int) -> None:
    for name, fn in calls.items():
        ms = cs.cuda_ms(fn)
        alone = isolated_ms(fn)
        by = kernel_times(fn)
        # per launch: the profiler may drop some of a run's events
        parts = "  ".join(
            f"{k.replace('(anonymous namespace)::', '').replace('void ', '').split('(')[0][:48]}"
            f" {n:.2f}x {t / n:.4f}" for k, (n, t) in sorted(by.items(), key=lambda kv: -kv[1][1]))
        print(f"{label} phase {phase} {name}: wrapper {ms:.4f} ms queued, {alone:.4f} "
              f"alone | by name: {parts}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("csrc", nargs="*", type=Path)
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_small_kernels: needs a CUDA card")
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    calls = {name: fn for name in args.shapes.split(",") if name
             for fn in [inputs(dev, name)] if fn is not None}

    base_flags = kernel_lib.NVCC_FLAGS
    dirs = args.csrc or [kernel_lib.CSRC_DIR]
    for d in dirs + (dirs[::-1] if len(dirs) > 1 else []):
        for phase in ((1, 2, 3, 4) if args.split else (4,)):
            kernel_lib._lib = None
            kernel_lib.CSRC_DIR = d.resolve()
            kernel_lib.NVCC_FLAGS = base_flags + ((
                f"-DTT_PRE_PHASES={phase}", f"-DTT_SINK_PHASES={phase}")
                if phase < 4 else ())
            kernel_lib.library()
            measure(d.name, calls, phase)
    kernel_lib.NVCC_FLAGS = base_flags
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
