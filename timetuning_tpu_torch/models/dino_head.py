"""DINO projection head and multi-crop wrapper, in PyTorch.

Counterpart of ``timetuning_tpu/models/dino_head.py`` (reference
dino_vision_transformer.py:297-370): ``DINOHead`` with a weight-normalised
last layer and ``MultiCropWrapper``, which runs the crops of one resolution
through the backbone as one batch. The weight-normalised layer keeps the
JAX module's parameters and layout: ``v`` [in, out] and ``g`` [out]; with
``norm_last_layer`` (DINO's default) ``g`` is fixed, as JAX's
``stop_gradient``. The BatchNorms of ``use_bn`` always use their running
statistics, as the JAX module's (``use_running_average=True``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class WeightNormDense(nn.Module):
    """``x @ (g * v / ||v||_columns)``, no bias."""

    def __init__(self, in_dim: int, features: int, trainable_g: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        bound = 1.0 / math.sqrt(in_dim)      # lecun normal, as the JAX init
        self.v = nn.Parameter(torch.randn(in_dim, features) * bound)
        self.g = nn.Parameter(torch.ones(features), requires_grad=trainable_g)

    def forward(self, x):
        kernel = self.g * self.v / (torch.linalg.vector_norm(
            self.v, dim=0, keepdim=True) + 1e-12)
        return x.to(self.dtype) @ kernel.to(self.dtype)


class DINOHead(nn.Module):
    def __init__(self, in_dim: int, out_dim: int = 65536, hidden_dim: int = 2048,
                 bottleneck_dim: int = 256, n_layers: int = 3, use_bn: bool = False,
                 norm_last_layer: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers = n_layers
        self.use_bn = use_bn
        self.dtype = dtype
        dims = [in_dim] + [hidden_dim] * (n_layers - 1)
        for i in range(n_layers - 1):
            self.add_module(f"mlp{i}", nn.Linear(dims[i], hidden_dim))
            if use_bn:
                self.add_module(f"bn{i}", nn.BatchNorm1d(hidden_dim))
        self.add_module(f"mlp{n_layers - 1}", nn.Linear(dims[-1], bottleneck_dim))
        self.last_layer = WeightNormDense(bottleneck_dim, out_dim,
                                          trainable_g=not norm_last_layer, dtype=dtype)

    def _dense(self, x, i):
        lin = getattr(self, f"mlp{i}")
        return F.linear(x.to(self.dtype), lin.weight.to(self.dtype), lin.bias.to(self.dtype))

    def forward(self, x):
        for i in range(self.n_layers - 1):
            x = self._dense(x, i)
            if self.use_bn:
                bn = getattr(self, f"bn{i}")
                x = F.batch_norm(x.float().reshape(-1, x.shape[-1]), bn.running_mean,
                                 bn.running_var, bn.weight, bn.bias, False, 0.0,
                                 bn.eps).reshape(x.shape).to(self.dtype)
            x = F.gelu(x, approximate="none")
        x = self._dense(x, self.n_layers - 1)
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
        return self.last_layer(x)


class MultiCropWrapper(nn.Module):
    """Run a backbone over a list of crops [B, H, W, 3], batching
    consecutive crops that share a resolution, then one head pass over the
    concatenated CLS tokens."""

    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, crops: Sequence[torch.Tensor]):
        outputs = []
        i = 0
        while i < len(crops):
            j = i
            while j < len(crops) and crops[j].shape[1:] == crops[i].shape[1:]:
                j += 1
            out = self.backbone(torch.cat(list(crops[i:j]), dim=0))
            outputs.append(out["tokens"][:, 0])       # CLS
            i = j
        return self.head(torch.cat(outputs, dim=0))
