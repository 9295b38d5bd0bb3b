"""Profiling hooks: a device trace around a block, named regions in it.

Counterpart of ``timetuning_tpu/obs/profiling.py`` (``jax.profiler``
there): ``torch.profiler`` with the CPU and, where there is a card, the CUDA
activities, written as a Chrome trace that TensorBoard and Perfetto read.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Capture a trace of the block into ``log_dir/trace.json``."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the trace's timeline."""
    from torch.profiler import record_function

    with record_function(name):
        yield
