"""DUL / videowalk baseline: a stride-8 ResNet18 and the space-time
clustering losses, on PyTorch.

Counterpart of ``timetuning_tpu/models/dul.py`` (reference dul_model.py: a
torchvision ResNet18 with layer3 / layer4 at stride 1, :14-66, and the
``Framework`` objective, :244-574). The zoo reads it as
``get_backbone("dul")``: the fast network's backbone features resized to a
fixed 28 x 28 grid (models.py:1063-1068). The losses' random draws (the
anchor grids' offsets, each clip's k-means) come from a ``torch.Generator``
or are handed in, so the tests can give both packages the same values.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from timetuning_tpu_torch.models.resnet import BasicBlock, ResNet
from timetuning_tpu_torch.ops import kmeans as km
from timetuning_tpu_torch.ops.resize import resize_bilinear


class DulResNet18(ResNet):
    """ResNet18 with stride-1 layer3 / layer4 (output stride 8); ``tokens``
    are layer4's activations, ``intermediates`` layer3's."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__(BasicBlock, ((64, 2, 1), (128, 2, 2), (256, 2, 1),
                                      (512, 2, 1)), dtype, ds_rule="dul")

    def forward(self, x, want_attention: bool = False):
        del want_attention
        x, _, x3 = self.trunk(x)
        B, C, h, w = x.shape
        return {"tokens": x.flatten(2).transpose(1, 2), "attention": None,
                "intermediates": [x3.flatten(2).transpose(1, 2)], "grid": (h, w)}


class DulBackbone(nn.Module):
    """The zoo's adapter (reference models.py:1063-1068): the stride-8
    features bilinearly resized to the fixed ``grid`` x ``grid`` (the values
    of ``jax.image.resize``, antialiased when shrinking) and flattened."""

    def __init__(self, dtype: torch.dtype = torch.float32, grid: int = 28):
        super().__init__()
        self.net = DulResNet18(dtype)
        self.grid = grid

    def forward(self, x, want_attention: bool = False):
        del want_attention
        out = self.net(x)
        h, w = out["grid"]
        t = out["tokens"]
        B, _, D = t.shape
        m = t.transpose(1, 2).reshape(B, D, h, w)
        m = resize_bilinear(m, (self.grid, self.grid))
        return {"tokens": m.flatten(2).transpose(1, 2), "attention": None,
                "grid": (self.grid, self.grid)}


def dul_state_dict_from_torch(sd) -> dict[str, torch.Tensor]:
    """A DUL ``Framework`` checkpoint (``torch.load(path)["model"]``,
    ``module.`` prefixes) as ``DulBackbone``'s state dict: the
    ``fast_net.backbone.*`` ResNet18 subtree under ``net.``, as
    ``dul_params_from_torch`` maps it (timetuning_tpu/models/dul.py:58)."""
    flat = {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in dict(sd).items()}
    prefix = "fast_net.backbone."
    bb = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    if not bb:
        raise ValueError("no fast_net.backbone.* keys found: not a DUL Framework "
                         "checkpoint (expected torch.load(path)['model'] layout)")
    return {f"net.{k}": torch.as_tensor(v).float() for k, v in bb.items()
            if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}


def sample_grid_indices(generator: torch.Generator | None, B: int, h: int, w: int,
                        n: int) -> torch.Tensor:
    """Reference ``_sample_index`` (dul_model.py:276-304): an n x n grid of
    pixel indices with one random (x, y) offset a clip. [B, n, n] flat h w
    indices."""
    xs, ys = w // n, h // n
    if xs < 1 or ys < 1:
        raise ValueError(f"sampling grid {n}x{n} larger than the {h}x{w} feature "
                         "grid: lower grid_size / grid_size_ref")
    x_off = torch.randint(0, xs, (B, 1, 1), generator=generator)
    y_off = torch.randint(0, ys, (B, 1, 1), generator=generator)
    x_s = torch.arange(0, w, xs)[:n][None, None, :] + x_off
    y_s = torch.arange(0, h, ys)[:n][None, :, None] + y_off
    return x_s + y_s * w


def _sample_from_frame0(x, index):
    """Reference ``_sample_from`` (dul_model.py:306-330): anchors by flat
    h w index in frame 0 of each clip. x [B, T, K, h, w], index [B, n, n] ->
    [B n n, K]."""
    B, T, K, h, w = x.shape
    f0 = x[:, 0].reshape(B, K, h * w).transpose(1, 2)
    idx = index.reshape(B, -1).to(x.device)
    return torch.gather(f0, 1, idx[:, :, None].expand(-1, -1, K)).reshape(-1, K)


def dul_framework_loss(key1, key2, generator: torch.Generator | None = None,
                       grid_size: int = 4, grid_size_ref: int = 4,
                       temperature: float = 0.07, ce_ref: float = 1.0,
                       sample_idx=None, sample_idx_ref=None) -> dict:
    """The reference DUL ``Framework`` objective
    (``timetuning_tpu/models/dul.dul_framework_loss``; dul_model.py:244-574):
    view 1's last frame becomes view 2's first; logits of every feature of
    both streams against the B n^2 anchors of view 1's first frame; pseudo
    labels from view 2 restricted to a pixel's own clip; pixelwise
    cross-entropy of view 1 over frames 1..T-1, plus InfoNCE between the
    two views' first-frame anchors. key1 [B, T+1, K, h, w], key2
    [B, T-1, K, h, w]. ``sample_idx`` / ``sample_idx_ref``: fixed anchor
    grids, else drawn from ``generator`` (the main grid first). Returns
    {"main", "temp", "cross_key"}."""
    key2 = torch.cat([key1[:, -1:], key2], dim=1)
    key1 = key1[:, :-1]
    B, T, K, h, w = key1.shape
    n = grid_size
    if sample_idx is None:
        sample_idx = sample_grid_indices(generator, B, h, w, n)
    anchors = _sample_from_frame0(key1, sample_idx)

    def flat(x):
        return x.reshape(B * T, K, h * w).transpose(1, 2).reshape(-1, K)

    inv_t = 1.0 / temperature
    vals_soft = (flat(key1) @ anchors.t()) * inv_t
    vals_pseudo = (flat(key2) @ anchors.t()) * inv_t
    row_clip = torch.arange(B, device=key1.device).repeat_interleave(T * h * w)
    col_clip = torch.arange(B, device=key1.device).repeat_interleave(n * n)
    eye = row_clip[:, None] == col_clip[None, :]
    pseudo = (torch.softmax(vals_pseudo, dim=1) * eye).argmax(dim=1)
    ce = F.cross_entropy(vals_soft, pseudo, reduction="none").reshape(B, T, h, w)
    loss_temp = ce[:, 1:].mean()

    if sample_idx_ref is None:
        sample_idx_ref = sample_grid_indices(generator, B, h, w, grid_size_ref)
    x1 = _sample_from_frame0(key1[:, :1], sample_idx_ref)
    y1 = _sample_from_frame0(key2[:, :1], sample_idx_ref)
    logits = (x1 @ y1.t()) * inv_t
    cross_key = F.cross_entropy(logits, torch.arange(logits.shape[1],
                                                     device=logits.device))
    return {"main": ce_ref * cross_key + loss_temp, "temp": loss_temp,
            "cross_key": cross_key}


def space_time_cluster_loss(features, key_frame: int = 0, n_clusters: int = 8,
                            temperature: float = 0.07,
                            generator: torch.Generator | None = None):
    """The compact form of the DUL objective
    (``timetuning_tpu/models/dul.space_time_cluster_loss``): k-means of each
    clip's key frame (10 iterations, one start; draws from ``generator``,
    clip by clip) gives pseudo labels, normalised cluster sums the
    centroids, and every frame's softmax over them is held to the labels.
    features [B, T, N, D]."""
    B, T, N, D = features.shape
    f = features / (torch.linalg.vector_norm(features, dim=-1, keepdim=True) + 1e-12)
    losses = []
    for b in range(B):
        fc = f[b]
        labels = km.kmeans(fc[key_frame], n_clusters, generator, n_iter=10,
                           n_redo=1).assignments
        cent = torch.zeros(n_clusters, D, dtype=fc.dtype,
                           device=fc.device).index_add_(0, labels, fc[key_frame])
        cent = cent / (torch.linalg.vector_norm(cent, dim=-1, keepdim=True) + 1e-12)
        logits = torch.einsum("tnd,kd->tnk", fc, cent) / temperature
        lab = labels[None].expand(T, N)
        losses.append(F.cross_entropy(logits.reshape(T * N, -1), lab.reshape(-1)))
    return torch.stack(losses).mean()
