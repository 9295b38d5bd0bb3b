#!/usr/bin/env python3
"""Time the TimeT train step of the tree this file sits in, at the flagship
width (``chip_smoke.build_train``: DINO ViT-S/16 224, head [1024, 1024, 512,
256], 200 prototypes, bf16, default configuration).

    python tools/time_train_step.py [label]

After three warm-up steps on each batch: ten steps at 32 clips and four at
128 clips, each timed alone with CUDA events around it (median, min, all),
and one ``chip_smoke.trace`` of five 32-clip steps (device busy, idle share,
device events a step, kernel time by name). To compare two commits in turns,
copy this file into an unpacked copy of the other commit's tree and run both,
parent, change, change, parent, in one call on one card. Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from timetuning_tpu_torch.ops import kernel_lib  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("time_train_step: needs a CUDA card")
    label = sys.argv[1] if len(sys.argv) > 1 else ROOT.name
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    kernel_lib.library()
    _, _, _, state, step = cs.build_train(dev, torch.bfloat16)
    for n_clips, reps in ((32, 10), (128, 4)):
        clip = cs.synthetic_train_clips(n_clips, dev, seed=n_clips)
        for _ in range(3):
            step(state, clip)
        torch.cuda.synchronize()
        ms = []
        for _ in range(reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            step(state, clip)
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        print(f"{label} step B={n_clips}: median {np.median(ms):.3f} ms, min "
              f"{min(ms):.3f}, all {[round(m, 2) for m in ms]}", flush=True)
        if n_clips == 32:
            cs.trace(lambda: step(state, clip), f"{label} step B=32", reps=5, top=6)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
