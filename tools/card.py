"""What the kernel timers (``time_block_kernels.py``, ``time_small_kernels.py``,
``time_propagation.py``) share: the card's name and power limit, a kernel's
device time by CUDA events, the device time of each kernel by name under
``torch.profiler``, and the propagation eval's synthetic clips, from the
benchmark's generator (``benchmark/generate.py``).
"""

from __future__ import annotations

import subprocess

import torch


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "n/a"


def cuda_ms(fn, warmup: int = 3, reps: int = 20, queued: bool = True) -> float:
    """Mean time of ``fn`` on the card (CUDA events over ``reps`` calls).
    ``queued``: the calls are queued behind a few milliseconds of device-side
    spinning, so a kernel of some ten microseconds is timed on the card and
    not by how fast the host enqueues it (a wrapper's Python and three
    tensor-map encodes take longer than such a kernel runs)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(8_000_000)    # device clocks: ~4-5 ms
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_times(fn, reps: int = 3) -> dict:
    """Device time of each kernel by name under ``torch.profiler``: (launches,
    ms) a call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        n, t = by.get(e.name(), (0, 0))
        by[e.name()] = (n + 1, t + e.end_ns() - e.start_ns())
    return {k: (n / reps, t / reps / 1e6) for k, (n, t) in by.items()}


def eval_clips(dev, seed: int = 0, n: int = 2, frames: int = 25):
    """The propagation eval's group: ``n`` DAVIS-size (480 x 854) clips of a
    textured box moving over noise, each with its mask, as (frames [T, H, W,
    3], mask [T, H, W]) uint8 pairs."""
    from benchmark import generate

    f, a = generate.clips(seed, n, frames, 480, 854, (1, 1), True, "noise", dev)
    return list(zip(f, a))
