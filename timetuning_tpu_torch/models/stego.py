"""STEGO's featurizer: DINO ViT-S/8 and the cluster projection, on PyTorch.

Counterpart of ``timetuning_tpu/models/stego.py`` (STEGO's ``DinoFeaturizer``,
Hamilton et al., ICLR 2022; the reference wrapped the external release,
models.py:872-875, and read it as flattened patch codes, models.py:1045-1053).
The frozen ViT's patch tokens go through ``code = cluster1(f) +
cluster2(f)``: cluster1 a 1 x 1 conv D -> dim, cluster2 a 1 x 1 conv D -> D,
ReLU, 1 x 1 conv D -> dim. A 1 x 1 conv on the patch grid is a dense layer on
the tokens, which is how they run here, in f32 (the JAX heads have no
compute dtype). The ViT takes the model's dtype: in bf16 at 224 its 785
tokens run the block kernels with the two-pass attention core.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from timetuning_tpu_torch.models.import_torch import strip_prefixes
from timetuning_tpu_torch.models.vit import VisionTransformer


class StegoFeaturizer(nn.Module):
    """-> {"tokens": [B, N, dim] projected patch codes (no CLS, as the
    reference's ``features.flatten(2).permute(0, 2, 1)``), "attention",
    "grid"}."""

    def __init__(self, backbone: VisionTransformer, dim: int = 70):
        super().__init__()
        self.backbone = backbone
        D = backbone.config.embed_dim
        self.cluster1 = nn.Linear(D, dim)
        self.cluster2_fc1 = nn.Linear(D, D)
        self.cluster2_fc2 = nn.Linear(D, dim)

    def forward(self, x, want_attention: bool = False):
        out = self.backbone(x, want_attention=want_attention)
        feats = out["tokens"][:, 1:].float()
        code = self.cluster1(feats) + self.cluster2_fc2(F.relu(self.cluster2_fc1(feats)))
        return {"tokens": code, "attention": out["attention"], "grid": out["grid"]}


def _conv1x1(w) -> torch.Tensor:
    """torch Conv2d 1 x 1 weight [O, I, 1, 1] -> Linear weight [O, I]."""
    return torch.as_tensor(np.asarray(w, np.float32)[:, :, 0, 0].copy())


def stego_state_dict_from_torch(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """A STEGO ``.ckpt`` state dict (``net.model.<timm ViT key>``,
    ``net.cluster1.*``, ``net.cluster2.{0,2}.*``; the probes ignored) as
    ``StegoFeaturizer``'s state dict, with the 1 x 1 convolutions as dense
    weights (the counterpart of ``stego_params_from_torch``,
    timetuning_tpu/models/stego.py:70)."""
    bb = {k[len("net.model."):]: v for k, v in sd.items() if k.startswith("net.model.")}
    if not bb:      # an already-stripped dict
        bb = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    out = {f"backbone.{k}": torch.as_tensor(np.asarray(v, np.float32))
           for k, v in strip_prefixes(bb).items()}

    def pick(*names):
        for n in names:
            if n in sd:
                return np.asarray(sd[n])
        raise KeyError(f"none of {names} in the checkpoint")

    for dst, src in (("cluster1", "cluster1"), ("cluster2_fc1", "cluster2.0"),
                     ("cluster2_fc2", "cluster2.2")):
        out[f"{dst}.weight"] = _conv1x1(pick(f"net.{src}.weight", f"{src}.weight"))
        out[f"{dst}.bias"] = torch.as_tensor(
            np.asarray(pick(f"net.{src}.bias", f"{src}.bias"), np.float32))
    return out
