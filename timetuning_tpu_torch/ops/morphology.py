"""Image morphology on the device: Gaussian blur, small-component removal,
dilation.

Counterpart of ``timetuning_tpu/ops/morphology.py`` (the reference leaned on
torchvision's GaussianBlur and ``skimage.measure.label`` in
``process_attentions``, models.py:93-131, and on skimage
``binary_dilation(disk(r))`` for the boundary metrics,
mask_propagation.py:547-549).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """torchvision GaussianBlur's kernel construction."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 0.6) -> torch.Tensor:
    """Separable Gaussian blur with reflect padding on [..., H, W], as
    torchvision's GaussianBlur pads (models.py:114). The taps are summed as
    shifted slices in the image's own dtype: a convolution on the card would
    go through TF32."""
    k = gaussian_kernel1d(ksize, sigma).tolist()
    pad = ksize // 2
    H, W = img.shape[-2:]
    x = F.pad(img.reshape(-1, 1, H, W), (pad, pad, pad, pad), mode="reflect")
    x = sum(k[i] * x[:, :, i:i + H, :] for i in range(ksize))
    x = sum(k[i] * x[:, :, :, i:i + W] for i in range(ksize))
    return x.reshape(img.shape)


def connected_components(mask: torch.Tensor) -> torch.Tensor:
    """Label the 8-connected components of binary [..., H, W] masks:
    iterative label flood, as the JAX version. Every foreground pixel is
    seeded with its linear index; the 3x3 neighbourhood max restricted to the
    mask is taken until nothing changes, so each component ends up carrying
    its largest seed. Background is -1. Returns int64 [..., H, W]. The loop
    reads one flag from the device per sweep."""
    H, W = mask.shape[-2:]
    m = mask.detach().reshape(-1, 1, H, W) > 0
    seeds = torch.arange(H * W, dtype=torch.float32,
                         device=mask.device).reshape(1, 1, H, W)
    labels = seeds.expand(m.shape).masked_fill(~m, float("-inf"))
    for _ in range(H * W):
        flooded = torch.maximum(labels, F.max_pool2d(labels, 3, 1, 1))
        flooded = flooded.masked_fill(~m, float("-inf"))
        changed = bool((flooded != labels).any())
        labels = flooded
        if not changed:
            break
    return labels.masked_fill(~m, -1.0).long().reshape(mask.shape)


def remove_small_components(mask: torch.Tensor, min_size: int = 3) -> torch.Tensor:
    """Zero out the 8-connected components smaller than ``min_size`` pixels
    (the <= 2-pixel removal of reference ``process_attentions``,
    models.py:126-130). Binary [..., H, W] in and out, each leading index a
    mask of its own."""
    H, W = mask.shape[-2:]
    labels = connected_components(mask).reshape(-1, H * W)
    fg = labels >= 0
    idx = torch.where(fg, labels, torch.zeros_like(labels))
    counts = torch.zeros_like(labels).scatter_add_(1, idx, fg.long())
    keep = fg & (counts.gather(1, idx) >= min_size)
    return keep.reshape(mask.shape).to(mask.dtype)


def dilate(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Dilate binary [..., H, W] masks with a disk of ``radius``; same dtype
    out. The disk count is a small integer sum, exact in f32 and in TF32."""
    if radius <= 0:
        return mask
    yy, xx = np.mgrid[-radius: radius + 1, -radius: radius + 1]
    disk = torch.from_numpy(((yy ** 2 + xx ** 2) <= radius ** 2).astype(np.float32))
    H, W = mask.shape[-2:]
    x = mask.float().reshape(-1, 1, H, W)
    out = F.conv2d(x, disk.to(mask.device)[None, None], padding=radius)
    return (out > 0).reshape(mask.shape).to(mask.dtype)
