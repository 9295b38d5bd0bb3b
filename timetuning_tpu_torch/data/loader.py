"""The clip loader of the JAX package, imported without JAX.

``make_loader`` and ``SamplingMode`` are ``timetuning_tpu/data/loader.py``'s
and ``timetuning_tpu/data/datasets.py``'s own (host threads, numpy, cv2/PIL
decode); see ``timetuning_tpu_torch/_host.py`` for how they are imported.
"""

from __future__ import annotations

from timetuning_tpu_torch._host import host_module


def make_loader(*args, **kw):
    # datasets first: loader.py imports it at module level, and only a
    # datasets module already in sys.modules keeps that import from running
    # the jax-importing package __init__
    host_module("data.datasets")
    return host_module("data.loader").make_loader(*args, **kw)


def sampling_mode(name: str):
    """``SamplingMode[name]`` of the JAX package's datasets module."""
    return host_module("data.datasets").SamplingMode[name]
