"""ResNet-18/50 dense-feature backbones (torchvision layout), on PyTorch.

Counterpart of ``timetuning_tpu/models/resnet.py`` (reference
models.py:146-408, the vendored torchvision ResNet read through a forward
hook on ``layer4[-1].conv2`` / ``.conv3``, models.py:939-957). The tap is
part of the forward: ``tokens`` are the pre-BN activations of the last
block's last convolution. Input NHWC, as the JAX package. Every BatchNorm
runs on its running statistics (eps 1e-5, as the JAX ``_BN``): these
backbones are frozen feature extractors in every reference path. Parameter
and buffer names are torchvision's, so a torchvision state dict loads with
``load_state_dict`` (``resnet_state_dict_from_torch`` strips its prefixes).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from timetuning_tpu_torch.models.import_torch import strip_prefixes


def bn_eval(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """``bn`` on its running statistics over NCHW ``x``, computed in f32 and
    returned in ``x``'s dtype (flax's BatchNorm with
    ``use_running_average=True`` and a compute dtype)."""
    return F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, False, 0.0, bn.eps).to(x.dtype)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


def conv(mod: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``mod`` in ``x``'s dtype (flax ``nn.Conv(dtype=...)``)."""
    b = None if mod.bias is None else mod.bias.to(x.dtype)
    return F.conv2d(x, mod.weight.to(x.dtype), b, mod.stride, mod.padding)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (nn.Sequential(_conv(cin, planes, 1, stride),
                                         nn.BatchNorm2d(planes))
                           if downsample else None)

    def forward(self, x):
        """-> (output, pre-BN activation of the last convolution)."""
        out = F.relu(bn_eval(self.bn1, conv(self.conv1, x)))
        pre_bn = conv(self.conv2, out)
        out = bn_eval(self.bn2, pre_bn)
        identity = x
        if self.downsample is not None:
            identity = bn_eval(self.downsample[1], conv(self.downsample[0], x))
        return F.relu(out + identity), pre_bn


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(_conv(cin, planes * 4, 1, stride),
                                         nn.BatchNorm2d(planes * 4))
                           if downsample else None)

    def forward(self, x):
        out = F.relu(bn_eval(self.bn1, conv(self.conv1, x)))
        out = F.relu(bn_eval(self.bn2, conv(self.conv2, out)))
        pre_bn = conv(self.conv3, out)
        out = bn_eval(self.bn3, pre_bn)
        identity = x
        if self.downsample is not None:
            identity = bn_eval(self.downsample[1], conv(self.downsample[0], x))
        return F.relu(out + identity), pre_bn


class ResNet(nn.Module):
    """``forward(x [B, H, W, 3])`` -> the ViT's dict: ``tokens`` [B, h w, C]
    the pre-BN activations of the final block's last convolution (the
    reference's hooked features), ``attention`` None, ``grid`` (h, w).

    ``plan``: (planes, blocks, stride of the first block) a layer;
    ``ds_rule``: which first blocks get a downsample (``"torchvision"``: a
    stride, a width change or a bottleneck; ``"dul"``: every layer but the
    first, as ``timetuning_tpu/models/dul.DulResNet18``)."""

    def __init__(self, block: type, plan: tuple, dtype: torch.dtype = torch.float32,
                 ds_rule: str = "torchvision"):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for li, (planes, n, stride) in enumerate(plan):
            blocks = []
            for bi in range(n):
                s = stride if bi == 0 else 1
                if ds_rule == "dul":
                    ds = bi == 0 and li > 0
                else:
                    ds = bi == 0 and (s != 1 or li > 0 or block is Bottleneck)
                blocks.append(block(cin, planes, s, ds))
                cin = planes * block.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.out_dim = cin

    def trunk(self, x):
        """NHWC in -> (final NCHW activations, the tap, layer3's output)."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(bn_eval(self.bn1, conv(self.conv1, x)))
        x = F.max_pool2d(x, 3, 2, 1)
        tap = x3 = None
        for li in range(1, 5):
            for blk in getattr(self, f"layer{li}"):
                x, tap = blk(x)
            if li == 3:
                x3 = x
        return x, tap, x3

    def forward(self, x, want_attention: bool = False):
        del want_attention
        _, tap, _ = self.trunk(x)
        B, C, h, w = tap.shape
        tokens = tap.flatten(2).transpose(1, 2)
        return {"tokens": tokens, "attention": None, "intermediates": [tokens],
                "grid": (h, w)}


def resnet18(dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet(BasicBlock, ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)),
                  dtype)


def resnet50(dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet(Bottleneck, ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)),
                  dtype)


def resnet_state_dict_from_torch(sd) -> dict[str, torch.Tensor]:
    """A torchvision ResNet state dict (``module.`` / ``backbone.`` /
    ... prefixes stripped, the ``fc`` head and ``num_batches_tracked``
    dropped) as this module's state dict: the counterpart of
    ``resnet_params_from_torch`` (timetuning_tpu/models/resnet.py:133)."""
    sd = strip_prefixes(dict(sd))
    return {k: torch.as_tensor(v).float() for k, v in sd.items()
            if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}
