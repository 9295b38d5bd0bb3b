#!/usr/bin/env python3
"""Device times of the propagation kernel (K3) at the main paths' shapes, and
its split into phases, for one or several copies of the kernel sources, in
turns inside one process on one card.

    python tools/time_propagation.py [--split] [--shapes s8,s16,...] [csrc_dir ...]

Shapes (``SHAPES``): ``s8`` the ViT-S/8 448 eval group (2 clips x 25 frames x
3,136 patches, D 384, 4 label channels, n_last 4, radius 12, top-k 5) on
lattice features (``tests/torch_dp_worker.lattice_features``: every dot
product exact),
in bf16 and f32; ``s16`` the ViT-S/16 224 eval group (196 patches) on
normal features, bf16 and f32; ``step`` the train step's (32 clips x 4
frames x 196 patches, 200 channels, n_last 7, radius 6) on lattice features
in bf16. Each line gives the wrapper's time (CUDA events over 10 calls queued
behind a device-side sleep, ``card.cuda_ms``) and the device time of
each kernel by name (``torch.profiler``), one call's worth.

``--split``: each source is also built with ``-DTT_PROP_PHASES=1``, ``2`` and
``3``: the affinity kernel stops after the products (1), after the window
mask and the test of each chunk's largest affinity against the row's
threshold (2), after the top-k lists (3); the full kernel is phase 4. The
kernel's own time is read by name, apart from the T-1 seg launches, which
return at once in phases 1-3 (their rows are not written there).

``--groups``: then the S/16 224 and S/8 448 bf16 eval groups with the first
directory's kernels, each group's time, K3's device time in it and its peak
memory (``torch.cuda.max_memory_allocated``).

Without a directory: the package's own ``timetuning_tpu_torch/csrc``. Needs a
CUDA card and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import card  # noqa: E402
from torch_dp_worker import lattice_features  # noqa: E402
from timetuning_tpu_torch.ops import kernel_lib  # noqa: E402
from timetuning_tpu_torch.ops import propagation_cuda as prc  # noqa: E402

# name: (clips, frames, patches, channels, n_last, radius, lattice, dtypes)
SHAPES = {
    "s8": (2, 25, 3136, 4, 4, 12, True, (torch.bfloat16, torch.float32)),
    "s16": (2, 25, 196, 4, 4, 12, False, (torch.bfloat16, torch.float32)),
    "step": (32, 4, 196, 200, 7, 6, True, (torch.bfloat16,)),
}

def inputs(dev, name, dtype):
    B, T, N, K, n_last, radius, lattice, _ = SHAPES[name]
    rng = np.random.default_rng(N)
    f = lattice_features(rng, (B, T, N)) if lattice else \
        rng.standard_normal((B, T, N, 384)).astype(np.float32)
    feats = torch.from_numpy(f).to(dev, dtype)
    seg0 = torch.softmax(torch.from_numpy(
        rng.standard_normal((B, K, N)).astype(np.float32)).to(dev) * 3, dim=1)
    return feats, seg0, dict(n_last=n_last, radius=radius, topk=5)


def measure(label, dev, data, phase: int) -> None:
    for (name, dtype), (feats, seg0, kw) in data.items():
        def fn():
            return prc.propagate_labels_batch_cuda(feats, seg0, **kw)

        ms = card.cuda_ms(fn, warmup=2, reps=10)
        by = card.kernel_times(fn)
        parts = "  ".join(
            f"{k.replace('(anonymous namespace)::', '').replace('void ', '').split('(')[0][:48]}"
            f" {n:.0f}x {t:.4f}" for k, (n, t) in sorted(by.items(), key=lambda kv: -kv[1][1]))
        print(f"{label} phase {phase} {name} {str(dtype)[6:]}: wrapper {ms:.4f} ms | "
              f"by name: {parts}", flush=True)


def groups(dev) -> None:
    """The S/16 224 and S/8 448 eval groups (``cli/propagate``'s per-group
    compute on ``card.eval_clips``, bf16): time and peak memory,
    K3's share of it by name."""
    from timetuning_tpu_torch.cli import propagate as prop
    from timetuning_tpu_torch.models.registry import get_backbone

    clips = card.eval_clips(dev)
    frames = torch.from_numpy(np.stack([f for f, _ in clips])).to(dev)
    for arch, size in (("dino-s16", 224), ("dino-s8", 448)):
        bb = get_backbone(arch, dtype=torch.bfloat16, device=dev)
        first = [prop.resize_nearest(torch.from_numpy(a[:1].astype(np.float32)),
                                     (size, size))[0].numpy().astype(np.int64)
                 for _, a in clips]
        onehots = torch.from_numpy(np.stack([
            prop.first_frame_onehot(f, bb.spatial_resolution(size), 4)
            for f in first])).to(dev)

        def group():
            return prop.propagate_clip_group(
                bb, frames, onehots, input_resolution=size, n_last=4, radius=12,
                topk=5, dtype=torch.bfloat16)

        group()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        group()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ms = card.cuda_ms(group, warmup=1, reps=5, queued=False)
        by = card.kernel_times(group, reps=2)
        k3 = sum(t for k, (_, t) in by.items() if "prop_" in k)
        print(f"group {arch}/{size} bf16: {ms:.3f} ms a group, K3 {k3:.4f} ms by name, "
              f"peak memory {peak / 2 ** 30:.3f} GiB ({(peak - base) / 2 ** 30:.3f} "
              f"above the weights and frames)", flush=True)
        del bb


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("csrc", nargs="*", type=Path)
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--groups", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_propagation: needs a CUDA card")
    print(card.nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    data = {(name, dtype): inputs(dev, name, dtype)
            for name in args.shapes.split(",") if name for dtype in SHAPES[name][-1]}

    base_flags = kernel_lib.NVCC_FLAGS
    dirs = args.csrc or [kernel_lib.CSRC_DIR]
    for d in dirs + (dirs[::-1] if len(dirs) > 1 else []):
        for phase in ((1, 2, 3, 4) if args.split else (4,)):
            kernel_lib._lib = None
            kernel_lib.CSRC_DIR = d.resolve()
            kernel_lib.NVCC_FLAGS = base_flags + (
                (f"-DTT_PROP_PHASES={phase}",) if phase < 4 else ())
            kernel_lib.library()
            measure(d.name, dev, data, phase)
    kernel_lib.NVCC_FLAGS = base_flags
    if args.groups:
        kernel_lib._lib = None
        kernel_lib.CSRC_DIR = dirs[0].resolve()
        groups(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
