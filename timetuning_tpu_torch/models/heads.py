"""Projection and probe heads.

Counterpart of ``timetuning_tpu/models/heads.py``: ``ProjectionHead``
(:11-28) and ``LinearProbeHead`` (:31-41).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's ``lecun_normal``: ``variance_scaling(1, "fan_in",
    "truncated_normal")`` draws a normal truncated at 2 std, with the std
    divided by 0.8796 (the std of a unit normal truncated at +-2) so that the
    kernel's variance is 1 / fan_in."""
    std = w[0].numel() ** -0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class ProjectionHead(nn.Module):
    """MLP projection head: Linear -> exact GELU between layers, linear last
    layer (reference FeatureExtractor head, models.py:914-926, default layer
    list [1024, 1024, 512, 256], time_tuning.py:575). Computes in ``dtype``
    (f32, as the JAX head): a bf16 input is widened first. Layers are named
    ``lin{i}`` as in the JAX tree."""

    def __init__(self, in_dim: int, layer_dims, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer_dims = tuple(layer_dims)
        self.dtype = dtype
        dims = (in_dim, *self.layer_dims)
        for i in range(len(self.layer_dims)):
            self.add_module(f"lin{i}", nn.Linear(dims[i], dims[i + 1]))

    def init_weights(self, generator: torch.Generator) -> "ProjectionHead":
        with torch.no_grad():
            for i in range(len(self.layer_dims)):
                lin = getattr(self, f"lin{i}")
                _lecun_normal_(lin.weight, generator)
                nn.init.zeros_(lin.bias)
        return self

    def forward(self, x):
        x = x.to(self.dtype)
        n = len(self.layer_dims)
        for i in range(n):
            lin = getattr(self, f"lin{i}")
            x = F.linear(x, lin.weight.to(self.dtype), lin.bias.to(self.dtype))
            if i != n - 1:
                x = F.gelu(x, approximate="none")
        return x


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
        Flax's ``nn.Conv``."""
        with torch.no_grad():
            _lecun_normal_(self.conv.weight, generator)
            nn.init.zeros_(self.conv.bias)
        return self

    def forward(self, x):
        w = self.conv.weight
        return F.linear(x, w.reshape(w.shape[0], -1), self.conv.bias)
