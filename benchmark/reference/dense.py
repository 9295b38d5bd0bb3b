"""The plain reference of the dense forward: the eval preprocess and the
features a serving program returns.

* Preprocess: uint8 frames -> [0, 1] -> bilinear resize to S x S,
  antialiased when shrinking (a triangle filter widened by the scale, as
  ``jax.image.resize``), normalised by the configuration's mean and std.
* Features: the ViT's patch features of the preprocessed frames.

Imports nothing of the program, of JAX, or of the JAX package.
"""

from __future__ import annotations

import torch

from benchmark.reference import vit
from benchmark.reference.augment import scale_translate_weights


def preprocess(frames_u8: torch.Tensor, size: int, mean, std) -> torch.Tensor:
    """[N, H, W, 3] uint8 -> [N, size, size, 3] f32."""
    N, H, W, _ = frames_u8.shape
    dev = frames_u8.device
    one = torch.ones(1, device=dev)
    wy = scale_translate_weights(H, size, one * (size / H), one * 0.0)[0]
    wx = scale_translate_weights(W, size, one * (size / W), one * 0.0)[0]
    x = frames_u8.float() / 255.0
    x = torch.einsum("nhwc,yh,xw->nyxc", x, wy, wx)
    return (x - torch.tensor(mean, device=dev)) / torch.tensor(std, device=dev)


@torch.no_grad()
def features(p: dict, frames_u8: torch.Tensor, s: vit.ViTShape, size: int, mean, std,
             quant=None, chunk: int = 5) -> torch.Tensor:
    """The patch features [N, P, D] of uint8 frames, ``chunk`` frames at a
    time (the attention of 3,137 tokens holds 236 MB a frame and head)."""
    out = [vit.features(p, preprocess(frames_u8[i:i + chunk], size, mean, std), s, quant)
           for i in range(0, frames_u8.shape[0], chunk)]
    return torch.cat(out)
