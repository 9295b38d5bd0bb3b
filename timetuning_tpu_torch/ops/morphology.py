"""Binary dilation for the boundary metrics.

Counterpart of ``dilate`` in ``timetuning_tpu/ops/morphology.py`` (the
reference used skimage ``binary_dilation(disk(r))``,
mask_propagation.py:547-549).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def dilate(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Dilate a binary [H, W] mask with a disk of ``radius``; same dtype out.
    The disk count is a small integer sum, exact in f32 and in TF32."""
    if radius <= 0:
        return mask
    yy, xx = np.mgrid[-radius: radius + 1, -radius: radius + 1]
    disk = torch.from_numpy(((yy ** 2 + xx ** 2) <= radius ** 2).astype(np.float32))
    x = mask.float()[None, None]
    out = F.conv2d(x, disk.to(mask.device)[None, None], padding=radius)[0, 0]
    return (out > 0).to(mask.dtype)
