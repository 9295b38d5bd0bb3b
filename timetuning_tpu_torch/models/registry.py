"""Backbone registry for the ViT architectures of the propagation eval.

Counterpart of ``timetuning_tpu/models/registry.py`` (reference
models.py:773-900), for the ViT names only: ``vit-tiny-test``,
``vit-tiny-test-p4``, ``dino-s16``, ``dino-s8`` and ``dino-b16``. The other
backbones of the JAX registry are still to port (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses

import torch

from timetuning_tpu_torch.models.vit import (
    ViTConfig,
    VisionTransformer,
    vit_base,
    vit_small,
)

# Checkpoint key prefixes stripped in priority order (the published TimeT.pth
# and the DINO/MoCo/MSN releases); copied from
# timetuning_tpu/models/import_torch.py:26-40.
_PREFIXES = (
    "feature_extractor.backbone.", "module.backbone.", "module.base_encoder.",
    "base_encoder.", "module.encoder.", "module.target_encoder.",
    "target_encoder.", "student.backbone.", "teacher.backbone.", "backbone.",
    "encoder.", "module.", "model.",
)
# Container keys unwrapped in order (import_torch.py:53-57).
_CONTAINERS = ("state_dict", "model_state_dict", "model", "teacher",
               "target_encoder", "encoder", "student", "model_state")


@dataclasses.dataclass
class Backbone:
    """A ready-to-apply backbone: module + metadata."""

    module: VisionTransformer
    patch_size: int
    feature_dim: int
    drop_cls: bool
    name: str

    def spatial_resolution(self, input_size: int = 224) -> int:
        return input_size // self.patch_size

    def apply(self, frames, want_attention: bool = False):
        out = self.module(frames, want_attention=want_attention)
        feats = out["tokens"]
        if self.drop_cls:
            feats = feats[:, 1:]
        return feats, out["attention"]


def _configs(dtype: torch.dtype) -> dict[str, ViTConfig]:
    tiny = dict(embed_dim=32, depth=2, num_heads=2, img_size=32, dtype=dtype)
    return {
        "vit-tiny-test": ViTConfig(patch_size=8, **tiny),
        "vit-tiny-test-p4": ViTConfig(patch_size=4, **tiny),
        "dino-s16": vit_small(16, dtype=dtype),
        "dino-s8": vit_small(8, dtype=dtype),
        "dino-b16": vit_base(16, dtype=dtype),
    }


def load_vit_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A reference-layout ``.pth`` as a timm/DINO ViT state dict: container
    keys unwrapped and known prefixes stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in _CONTAINERS:
        if key in obj and isinstance(obj[key], dict):
            obj = obj[key]
            break
    sd = {}
    for k, v in obj.items():
        if not torch.is_tensor(v):
            continue
        for p in _PREFIXES:
            if k.startswith(p):
                k = k[len(p):]
                break
        sd[k] = v
    return sd


def get_backbone(name: str, model_path: str | None = None,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cpu", seed: int = 0) -> Backbone:
    """Build a ViT backbone on ``device``. With ``model_path`` the
    reference-layout weights load into the module with ``load_state_dict``;
    without, the weights are a seeded random init."""
    cfgs = _configs(dtype)
    key = name.lower()
    if key not in cfgs:
        raise ValueError(f"unknown or not yet ported backbone {name!r}; the "
                         f"port has {sorted(cfgs)}")
    cfg = cfgs[key]
    module = VisionTransformer(cfg)
    if model_path:
        sd = load_vit_state_dict(model_path)
        # head weights of a TimeT.pth share the file and are not the ViT's
        sd = {k: v for k, v in sd.items() if k in module.state_dict()}
        module.load_state_dict(sd, strict=True)
    else:
        module.init_weights(torch.Generator().manual_seed(seed))
    module = module.to(device).eval()
    return Backbone(module, cfg.patch_size, cfg.embed_dim, True, key)
