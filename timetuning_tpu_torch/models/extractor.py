"""FeatureExtractor: backbone -> dense patch features (+ optional projection
head, + last self-attention), and the attention-derived foreground masking.

Counterpart of ``timetuning_tpu/models/extractor.py`` (reference
models.py:903-1078 FeatureExtractor, :1083-1216 FeatureExtractorV2, :93-144
process_attentions / apply_attention_mask). As there, "freezing" is not a
module property: which parameters train is a mask built from name patterns
(core/optimizer.py). The blur, the mass threshold and the component removal
run on the tensors' device (ops/morphology.py).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from timetuning_tpu_torch.models.heads import ProjectionHead
from timetuning_tpu_torch.ops.morphology import gaussian_blur, remove_small_components


class FeatureExtractor(nn.Module):
    """Wraps a backbone; returns (patch features [B, N, D], attention).

    ``backbone(x, want_attention=...)`` returns a dict with ``tokens``
    [B, 1+N, D] (CLS first) and ``attention`` (the VisionTransformer
    contract); ``feature_dim`` is its token width. ``head_dims`` adds the
    projection MLP. ``start_block`` / ``attn_impl`` pass through to the
    backbone: with ``start_block=k``, ``x`` is the hidden tokens of a shared
    trunk and only blocks [k, depth), the norm and the head run."""

    def __init__(self, backbone: nn.Module, feature_dim: int,
                 head_dims: Sequence[int] = (), drop_cls: bool = True):
        super().__init__()
        self.backbone = backbone
        self.head_dims = tuple(head_dims)
        self.drop_cls = drop_cls
        if self.head_dims:
            self.head = ProjectionHead(feature_dim, self.head_dims)

    def forward(self, x, use_head: bool = True, want_attention: bool = False,
                start_block: int = 0, attn_impl: str | None = None):
        out = self.backbone(x, want_attention=want_attention,
                            start_block=start_block, attn_impl=attn_impl)
        feats = out["tokens"]
        if self.drop_cls:
            feats = feats[:, 1:]
        if self.head_dims and use_head:
            feats = self.head(feats)
        return feats, out.get("attention")


class FeatureExtractorV2(nn.Module):
    """Dual-head extractor: separate projection MLPs for the segmentation
    (Sinkhorn / prototype) space and the propagation (affinity) space
    (reference models.py:1083-1216). Returns ((seg_features, prop_features),
    attention); a head with no dims passes the backbone features through."""

    def __init__(self, backbone: nn.Module, feature_dim: int,
                 segmentation_head_dims: Sequence[int] = (),
                 propagation_head_dims: Sequence[int] = (),
                 drop_cls: bool = True):
        super().__init__()
        self.backbone = backbone
        self.segmentation_head_dims = tuple(segmentation_head_dims)
        self.propagation_head_dims = tuple(propagation_head_dims)
        self.drop_cls = drop_cls
        if self.segmentation_head_dims:
            self.segmentation_head = ProjectionHead(
                feature_dim, self.segmentation_head_dims)
        if self.propagation_head_dims:
            self.propagation_head = ProjectionHead(
                feature_dim, self.propagation_head_dims)

    def forward(self, x, use_segmentation_head: bool = True,
                use_propagation_head: bool = True, want_attention: bool = False):
        out = self.backbone(x, want_attention=want_attention)
        feats = out["tokens"]
        if self.drop_cls:
            feats = feats[:, 1:]
        seg = prop = feats
        if self.segmentation_head_dims and use_segmentation_head:
            seg = self.segmentation_head(feats)
        if self.propagation_head_dims and use_propagation_head:
            prop = self.propagation_head(feats)
        return (seg, prop), out.get("attention")


def process_attentions(attentions: torch.Tensor, spatial_res: int,
                       threshold: float = 0.65,
                       blur_sigma: float = 0.6) -> torch.Tensor:
    """CLS attention -> binary foreground mask (reference models.py:93-131):
    the CLS -> patch attention averaged over heads, Gaussian-blurred (7x7,
    sigma 0.6), the top ``threshold`` fraction of the attention mass kept,
    8-connected components of <= 2 pixels dropped. [B, heads, 1+N, 1+N] ->
    [B, 1, res, res] f32, no gradient. The sort is stable, so tied values
    keep JAX's order."""
    att = attentions.detach()[:, :, 0, 1:].float()               # [B, heads, N]
    B, nh, _ = att.shape
    att = att.reshape(B, nh, spatial_res, spatial_res).mean(dim=1)
    flat = gaussian_blur(att, ksize=7, sigma=blur_sigma).reshape(B, -1)
    # sort ascending, mark the entries past the (1 - threshold) cumulative
    # point, un-sort
    order = torch.argsort(flat, dim=-1, stable=True)
    val = torch.gather(flat, -1, order)
    val = val / val.sum(dim=-1, keepdim=True)
    keep_sorted = torch.cumsum(val, dim=-1) > (1 - threshold)
    keep = torch.zeros_like(keep_sorted).scatter_(-1, order, keep_sorted)
    mask = keep.reshape(B, spatial_res, spatial_res).float()
    return remove_small_components(mask, min_size=3)[:, None]


def apply_attention_mask(features: torch.Tensor, attentions: torch.Tensor,
                         spatial_res: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero the background patch features with the foreground mask
    (reference models.py:133-144). features [B, F, N, D], attentions
    [B*F, heads, 1+N, 1+N] -> (masked features, masks [B, F, N])."""
    B, Fr, N, _ = features.shape
    masks = process_attentions(attentions, spatial_res).reshape(B, Fr, N, 1)
    return features * masks, masks[..., 0]
