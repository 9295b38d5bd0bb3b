"""FCN segmentation decode head (Leopart-style), in PyTorch.

Counterpart of ``timetuning_tpu/models/fcn.py`` (reference leopart.py:13-147,
``FCNHead`` on mmcv ConvModule): conv-BN-ReLU stacks over a backbone feature
map, an optional concat of the input and a 1x1 classifier. Layout as the
JAX module's, [B, H, W, C] in and out; the sub-module names are its own
(``conv{i}``, ``bn{i}``, ``conv_cat``, ``bn_cat``, ``cls``). BatchNorm uses
its running statistics in eval mode and the batch's in train mode, where it
updates the running ones as Flax's ``BatchNorm(momentum=0.9)`` does (torch's
momentum 0.1, but the biased batch variance into the running variance,
where torch would store the unbiased one); dropout only in train mode.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class FCNHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, channels: int = 256,
                 num_convs: int = 2, concat_input: bool = True,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_convs = num_convs
        self.concat_input = concat_input
        self.dtype = dtype
        c_in = in_channels
        for i in range(num_convs):
            self.add_module(f"conv{i}", nn.Conv2d(c_in, channels, 3, padding=1, bias=False))
            self.add_module(f"bn{i}", nn.BatchNorm2d(channels))
            c_in = channels
        if concat_input:
            self.conv_cat = nn.Conv2d(in_channels + channels, channels, 3, padding=1,
                                      bias=False)
            self.bn_cat = nn.BatchNorm2d(channels)
        self.drop = nn.Dropout(dropout)
        self.cls = nn.Conv2d(channels, num_classes, 1)

    def _conv_bn_relu(self, x, conv, bn):
        y = F.conv2d(x.to(self.dtype), conv.weight.to(self.dtype), padding=1).float()
        if self.training:
            mean = y.mean(dim=(0, 2, 3))
            var = y.var(dim=(0, 2, 3), unbiased=False)
            with torch.no_grad():
                m = bn.momentum
                bn.running_mean.mul_(1 - m).add_(m * mean)
                bn.running_var.mul_(1 - m).add_(m * var)
        else:
            mean, var = bn.running_mean, bn.running_var
        mul = torch.rsqrt(var + bn.eps) * bn.weight          # Flax's arithmetic
        y = (y - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
        return F.relu(y.to(self.dtype))

    def forward(self, x):
        """x: [B, H, W, C] feature map -> [B, H, W, num_classes] logits."""
        inp = x.permute(0, 3, 1, 2)
        y = inp
        for i in range(self.num_convs):
            y = self._conv_bn_relu(y, getattr(self, f"conv{i}"), getattr(self, f"bn{i}"))
        if self.concat_input:
            y = self._conv_bn_relu(torch.cat([inp.to(y.dtype), y], dim=1),
                                   self.conv_cat, self.bn_cat)
        y = self.drop(y)
        out = F.conv2d(y, self.cls.weight.to(self.dtype), self.cls.bias.to(self.dtype))
        return out.permute(0, 2, 3, 1)
