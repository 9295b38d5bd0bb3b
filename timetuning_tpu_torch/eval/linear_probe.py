"""Linear probing of frozen features on Pascal VOC.

Counterpart of ``timetuning_tpu/eval/linear_probe.py`` (reference
linear_finetune.py:55-89): a 1x1 conv head over the frozen backbone's patch
grid, bilinearly upsampled to ``mask_size``, trained with SGD (momentum 0.9,
weight decay 1e-4) under a step-decay schedule and a cross-entropy that
ignores label 255; validation reports ``PredsmIoU`` in linear-probe mode
(``eval/metrics.py``).

The numbers follow the JAX trainer step for step:

* the schedule is optax's ``piecewise_constant_schedule``: update n (from 0)
  takes ``lr * factor ** #{boundaries <= n}``, the boundaries at
  ``lr_drop_every * steps_per_epoch * i``;
* ``add_decayed_weights`` before momentum SGD, on every parameter, bias
  included, is torch SGD's ``weight_decay`` with ``momentum``;
* the masked cross-entropy divides by ``max(#valid, 1)``, so an all-ignored
  batch has loss 0 and zero gradients (not NaN);
* the logits are upsampled by ``ops/resize.resize_bilinear``, the
  ``jax.image.resize`` semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from timetuning_tpu_torch.eval.metrics import PredsmIoU
from timetuning_tpu_torch.models.heads import LinearProbeHead
from timetuning_tpu_torch.ops.resize import resize_bilinear


@dataclasses.dataclass
class LinearProbeConfig:
    num_classes: int = 21
    mask_size: int = 100
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 1e-4
    lr_drop_every: int = 20     # epochs
    lr_drop_factor: float = 0.1
    num_epochs: int = 50
    ignore_index: int = 255


class LinearProbeTrainer:
    """Head-only trainer over a frozen ``feature_fn``.

    ``feature_fn(frames_u8) -> [B, N, D]`` on the training device, typically
    the eval preprocess and the backbone forward under ``torch.no_grad``.
    """

    def __init__(self, feature_fn: Callable, spatial_resolution: int,
                 cfg: LinearProbeConfig, steps_per_epoch: int):
        self.feature_fn = feature_fn
        self.res = spatial_resolution
        self.cfg = cfg
        # a dict's keys in the JAX trainer: equal boundaries count once
        self.boundaries = sorted({
            cfg.lr_drop_every * steps_per_epoch * i
            for i in range(1, cfg.num_epochs // cfg.lr_drop_every + 1)})
        self.head: LinearProbeHead | None = None
        self.opt: torch.optim.SGD | None = None
        self.step_count = 0

    def lr_at(self, count: int) -> float:
        return self.cfg.lr * self.cfg.lr_drop_factor ** sum(
            count >= b for b in self.boundaries)

    def init(self, sample_feats: torch.Tensor) -> None:
        # seed 0, as the JAX trainer's PRNGKey(0) (its draws differ)
        head = LinearProbeHead(sample_feats.shape[-1], self.cfg.num_classes)
        self.head = head.init_weights(
            torch.Generator().manual_seed(0)).to(sample_feats.device)
        self.opt = torch.optim.SGD(
            self.head.parameters(), lr=self.cfg.lr, momentum=self.cfg.momentum,
            weight_decay=self.cfg.weight_decay)
        self.step_count = 0

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, N, D] patch features -> [B, C, mask_size, mask_size] logits."""
        B, _, D = feats.shape
        logits = self.head(feats.reshape(B, self.res, self.res, D))
        return resize_bilinear(logits.permute(0, 3, 1, 2),
                               (self.cfg.mask_size, self.cfg.mask_size))

    def loss(self, logits: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        labels = masks.long()
        valid = labels != self.cfg.ignore_index
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        ce = -F.log_softmax(logits, dim=1).gather(1, safe[:, None])[:, 0]
        return (ce * valid).sum() / valid.sum().clamp(min=1)

    def train_step(self, feats: torch.Tensor, masks: torch.Tensor) -> float:
        for group in self.opt.param_groups:
            group["lr"] = self.lr_at(self.step_count)
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(self.forward(feats), masks)
        loss.backward()
        self.opt.step()
        self.step_count += 1
        return loss.item()

    def train_epoch(self, loader) -> float:
        losses = []
        for frames, masks in loader:
            feats = self.feature_fn(frames)
            if self.head is None:
                self.init(feats)
            losses.append(self.train_step(
                feats, torch.as_tensor(np.asarray(masks), device=feats.device)))
        return float(np.mean(losses))

    @torch.no_grad()
    def validate(self, loader) -> float:
        """mIoU with linear_probe matching (reference linear_finetune.py:34-51)."""
        metric = PredsmIoU(
            self.cfg.num_classes, self.cfg.num_classes, involve_bg=True)
        for frames, masks in loader:
            preds = self.forward(self.feature_fn(frames)).argmax(dim=1)
            preds = preds.cpu().numpy()
            masks = np.asarray(masks)
            keep = masks != self.cfg.ignore_index
            metric.update(masks[keep].reshape(-1), preds[keep].reshape(-1))
        return metric.compute(True, linear_probe=True)[0]
