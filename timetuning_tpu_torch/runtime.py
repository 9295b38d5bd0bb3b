"""Process-level runtime choices of the port: the device, and the NaN
sanitiser.

Of ``timetuning_tpu/runtime.py`` only ``enable_debug_nans`` has a meaning
here; the rest there is JAX platform and compilation-cache setup.
"""

from __future__ import annotations


def resolve_device(device: str | None):
    """``device`` when given; else the card, and an error where there is
    none: the port never takes the CPU without being asked to."""
    import torch

    if device:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found (torch.cuda.is_available() is false) and no "
            "device given; pass --device cpu (device='cpu') to run on the host")
    return torch.device("cuda")


def enable_debug_nans(flag: bool) -> None:
    """Numerical sanitiser behind a flag: autograd's anomaly mode, which
    raises at the backward op that produced a NaN (the reference enabled it
    globally with ``np.seterr(all='raise')``, time_tuning.py:523-524)."""
    import torch

    torch.autograd.set_detect_anomaly(bool(flag))
