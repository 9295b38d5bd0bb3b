"""Probe heads.

Counterpart of ``timetuning_tpu/models/heads.py`` for ``LinearProbeHead``
(:31-41). ``ProjectionHead`` comes with the train step (ROADMAP queue 1).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class LinearProbeHead(nn.Module):
    """1x1 conv over the patch grid -> class logits (reference
    linear_finetune.py:21-31: ``Conv2d(feature_dim, num_classes, 1)``).

    ``forward(x)`` with x: [B, H, W, D] (NHWC, as the JAX head) returns
    [B, H, W, C]. The parameters keep torch's Conv2d layout (``conv.weight``
    [C, D, 1, 1]); a 1x1 conv is a per-patch linear map, applied as one."""

    def __init__(self, feature_dim: int, num_classes: int):
        super().__init__()
        self.conv = nn.Conv2d(feature_dim, num_classes, 1)

    def init_weights(self, generator: torch.Generator) -> "LinearProbeHead":
        """Seeded LeCun-normal kernel and zero bias, the initialisers of
        Flax's ``nn.Conv``: ``variance_scaling(1, "fan_in",
        "truncated_normal")`` draws a normal truncated at 2 std, with the std
        divided by 0.8796 (the std of a unit normal truncated at +-2) so that
        the kernel's variance is 1 / fan_in."""
        w = self.conv.weight
        std = w[0].numel() ** -0.5 / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            nn.init.zeros_(self.conv.bias)
        return self

    def forward(self, x):
        w = self.conv.weight
        return F.linear(x, w.reshape(w.shape[0], -1), self.conv.bias)
