"""Shared ops helpers."""

from __future__ import annotations

import functools


def pad_to_multiple(n: int, m: int = 128) -> int:
    """Smallest multiple of ``m`` that is >= ``n``."""
    return ((n + m - 1) // m) * m


def device_constant(fn):
    """Cache ``fn``, which makes a constant tensor from host data on the
    device its arguments name, once per arguments: a copy from pageable host
    memory on every call waits for the device, and a CUDA graph cannot hold
    one. While ``torch.export`` or ``torch.compile`` traces, the tensor made
    is a fake one, so it is made anew and not kept. Callers do not write to
    the result."""
    import torch

    cached = functools.lru_cache(maxsize=128)(fn)

    @functools.wraps(fn)
    def get(*args):
        if torch.compiler.is_exporting() or torch.compiler.is_compiling():
            return fn(*args)
        return cached(*args)

    return get
