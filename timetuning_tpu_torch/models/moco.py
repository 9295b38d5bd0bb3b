"""MoCo-v3 pieces: the ConvStem, the ViT configurations, the predictor and
the contrastive loss, on PyTorch.

Counterpart of ``timetuning_tpu/models/moco.py`` (reference
models.py:1604-1707 ``VisionTransformerMoCo`` + ``ConvStem``,
models.py:1710-1822 ``MoCo`` / ``MoCo_ViT``). The released ViT-S/B
checkpoints use the standard patch embedding (``models/vit``); ViT-S/16 has
12 heads of 32, which the bf16 block kernel serves. ``contrastive_loss``
gathers the keys over the data axis's process group, as the JAX loss does
over its mesh axis.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from timetuning_tpu_torch.models.vit import ViTConfig


class FlaxBatchNorm(nn.Module):
    """Flax's ``BatchNorm`` (momentum 0.9, eps 1e-5) over the last axis: in
    train mode the batch's mean and biased variance (E[x^2] - E[x]^2)
    normalise, and the running statistics move by 0.1 toward them (torch's
    BatchNorm would move the variance toward the unbiased one); in eval mode
    the running statistics normalise. ``affine=False``: no scale or bias."""

    def __init__(self, dim: int, affine: bool = True, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(dim)) if affine else None
        self.bias = nn.Parameter(torch.zeros(dim)) if affine else None
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x, train: bool = False):
        xf = x.float()
        if train:
            axes = tuple(range(xf.dim() - 1))
            mean = xf.mean(dim=axes)
            var = ((xf * xf).mean(dim=axes) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean.detach())
                self.running_var.mul_(m).add_((1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight + self.bias
        return y.to(x.dtype)


class ConvStem(nn.Module):
    """4 x (3 x 3 stride-2 conv, BatchNorm, ReLU) and a 1 x 1 projection,
    NHWC in and out (reference ``ConvStem``, models.py:1664-1707)."""

    def __init__(self, embed_dim: int = 384, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        dims = [3, embed_dim // 8, embed_dim // 4, embed_dim // 2, embed_dim]
        for i in range(4):
            setattr(self, f"conv{i}", nn.Conv2d(dims[i], dims[i + 1], 3, 2, 1,
                                                bias=False))
            setattr(self, f"bn{i}", FlaxBatchNorm(dims[i + 1]))
        self.proj = nn.Conv2d(embed_dim, embed_dim, 1)

    def forward(self, x, train: bool = False):
        x = x.to(self.dtype)
        for i in range(4):
            c = getattr(self, f"conv{i}")
            y = F.conv2d(x.permute(0, 3, 1, 2), c.weight.to(x.dtype), None, 2, 1)
            x = F.relu(getattr(self, f"bn{i}")(y.permute(0, 2, 3, 1), train))
        y = F.conv2d(x.permute(0, 3, 1, 2), self.proj.weight.to(x.dtype),
                     self.proj.bias.to(x.dtype))
        return y.permute(0, 2, 3, 1)


def moco_vit_small(**kw) -> ViTConfig:
    """MoCo-v3 ViT-S/16: 12 heads (DINO's has 6)."""
    return ViTConfig(patch_size=16, embed_dim=384, depth=12, num_heads=12, **kw)


def moco_vit_base(**kw) -> ViTConfig:
    return ViTConfig(patch_size=16, embed_dim=768, depth=12, num_heads=12, **kw)


class MoCoPredictor(nn.Module):
    """The two-layer BN-MLP prediction head (reference models.py:1736-1760,
    ``_build_mlp(2, in, hidden, out, last_bn=True)``): the last BatchNorm has
    no scale or bias."""

    def __init__(self, in_dim: int = 256, hidden_dim: int = 4096, out_dim: int = 256):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim, bias=False)
        self.bn1 = FlaxBatchNorm(hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim, bias=False)
        self.bn2 = FlaxBatchNorm(out_dim, affine=False)

    def forward(self, x, train: bool = False):
        x = F.relu(self.bn1(self.fc1(x), train))
        return self.bn2(self.fc2(x), train)


def import_moco_predictor(state_dict, prefix: str = "predictor.") -> dict[str, torch.Tensor]:
    """The official MoCo-v3 predictor ``nn.Sequential`` (0 Linear, 1
    BatchNorm1d, 3 Linear, 4 BatchNorm1d without affine; reference
    models.py:1749-1763) as ``MoCoPredictor``'s state dict."""
    def arr(key):
        return torch.as_tensor(np.asarray(state_dict[prefix + key], np.float32))

    return {
        "fc1.weight": arr("0.weight"), "bn1.weight": arr("1.weight"),
        "bn1.bias": arr("1.bias"), "bn1.running_mean": arr("1.running_mean"),
        "bn1.running_var": arr("1.running_var"), "fc2.weight": arr("3.weight"),
        "bn2.running_mean": arr("4.running_mean"),
        "bn2.running_var": arr("4.running_var"),
    }


def contrastive_loss(q, k, temperature: float = 0.2, axis_name: str | None = None):
    """InfoNCE (reference ``MoCo.contrastive_loss``, models.py:1775-1790):
    q and k normalised, logits q k^T / T in f32, positives on the diagonal,
    the mean cross-entropy times 2 T. With ``axis_name`` the keys of every
    rank of the default process group are gathered (``concat_all_gather``,
    JAX's ``all_gather``) and rank r's positives sit at r * n + i; the other
    ranks' keys carry no gradient here (the reference's gather has none)."""
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
    k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-12)
    n = q.shape[0]
    offset = 0
    if axis_name is not None:
        from timetuning_tpu_torch.parallel.mesh import (
            all_gather_rows,
            data_group,
            data_rank,
        )

        group = data_group(axis_name)
        offset = data_rank(group) * n
        with torch.no_grad():
            k_all = all_gather_rows(k.detach(), group)
        k = torch.cat([k_all[:offset], k, k_all[offset + n:]])
    logits = torch.einsum("nd,md->nm", q.float(), k.float()) / temperature
    labels = torch.arange(n, device=q.device) + offset
    return F.cross_entropy(logits, labels) * (2 * temperature)
