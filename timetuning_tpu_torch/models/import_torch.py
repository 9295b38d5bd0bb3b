# The port's own copy of timetuning_tpu/models/import_torch.py (host code, no JAX), with its
# imports of the package renamed; tests/test_torch_host_copies.py pins it to the original.
"""PyTorch → JAX checkpoint import.

The published checkpoint contract (reference README.md:66-76): ``TimeT.pth``
keys are ``feature_extractor.backbone.<timm vit_small_patch16_224 key>`` plus
the projection head and prototype bank; DINO/MAE/MoCo-v3/MSN/iBOT releases use
assorted prefixes (reference leopart.py:151-216 strips them). This module maps
any of those state dicts onto the Flax ViT pytree
(timetuning_tpu.models.vit.VisionTransformer).

Layout conversions (torch → flax):
  * Linear:   weight [out, in]        → kernel [in, out]   (transpose)
  * Conv2d:   weight [O, I, kh, kw]   → kernel [kh, kw, I, O]
  * LayerNorm: weight/bias            → scale/bias
QKV packing needs no reordering: both sides order the fused dim as
(3, heads, head_dim).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np

# Prefixes stripped in priority order (longest first).
_PREFIXES = [
    "feature_extractor.backbone.",  # TimeT.pth
    "module.backbone.",
    "module.base_encoder.",         # MoCo-v3
    "base_encoder.",
    "module.encoder.",
    "module.target_encoder.",       # MSN
    "target_encoder.",
    "student.backbone.",            # DINO full ckpt
    "teacher.backbone.",
    "backbone.",
    "encoder.",
    "module.",
    "model.",
]


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """Load a .pth file to numpy without keeping torch tensors around."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        # 'target_encoder'/'encoder' unwrap the released MSN layout
        # ({'encoder': sd, 'target_encoder': sd, ...} — the reference loads
        # torch.load(path)['target_encoder'], leopart.py); order matters:
        # prefer the EMA target like the reference
        for key in ("state_dict", "model_state_dict", "model", "teacher",
                    "target_encoder", "encoder", "student", "model_state"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    return {k: np.asarray(v.detach().cpu().numpy()) if hasattr(v, "detach") else np.asarray(v)
            for k, v in obj.items() if hasattr(v, "shape")}


def strip_prefixes(sd: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    out = {}
    for k, v in sd.items():
        for p in _PREFIXES:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


def vit_params_from_torch(sd: Mapping[str, np.ndarray]) -> dict:
    """Build the Flax VisionTransformer params dict from torch ViT keys."""
    sd = strip_prefixes(sd)
    p: dict = {}

    def t(w):  # linear weight
        return np.ascontiguousarray(w.T)

    p["cls_token"] = sd["cls_token"]
    p["pos_embed"] = sd["pos_embed"]
    p["patch_embed"] = {
        "kernel": np.ascontiguousarray(
            np.transpose(sd["patch_embed.proj.weight"], (2, 3, 1, 0))
        ),
        "bias": sd["patch_embed.proj.bias"],
    }
    depth = 1 + max(
        int(m.group(1))
        for k in sd
        if (m := re.match(r"blocks\.(\d+)\.", k))
    )
    for i in range(depth):
        b = f"blocks.{i}."
        p[f"blocks_{i}"] = {
            "norm1": {"scale": sd[b + "norm1.weight"], "bias": sd[b + "norm1.bias"]},
            "norm2": {"scale": sd[b + "norm2.weight"], "bias": sd[b + "norm2.bias"]},
            "attn": {
                "qkv": {
                    "kernel": t(sd[b + "attn.qkv.weight"]),
                    **(
                        {"bias": sd[b + "attn.qkv.bias"]}
                        if b + "attn.qkv.bias" in sd
                        else {}
                    ),
                },
                "proj": {
                    "kernel": t(sd[b + "attn.proj.weight"]),
                    "bias": sd[b + "attn.proj.bias"],
                },
            },
            "mlp": {
                "fc1": {
                    "kernel": t(sd[b + "mlp.fc1.weight"]),
                    "bias": sd[b + "mlp.fc1.bias"],
                },
                "fc2": {
                    "kernel": t(sd[b + "mlp.fc2.weight"]),
                    "bias": sd[b + "mlp.fc2.bias"],
                },
            },
        }
    p["norm"] = {"scale": sd["norm.weight"], "bias": sd["norm.bias"]}
    return p


def head_params_from_torch(
    sd: Mapping[str, np.ndarray], prefix: str = "feature_extractor.head."
) -> dict:
    """Projection-head import: the reference head is an nn.Sequential of
    Linear/GELU (models.py:914-926) → Sequential indices 0,2,4,6 are the
    Linears, mapping to ProjectionHead lin0..lin3."""
    layers = sorted(
        {
            int(m.group(1))
            for k in sd
            if (m := re.match(re.escape(prefix) + r"(\d+)\.weight", k))
        }
    )
    out = {}
    for j, idx in enumerate(layers):
        out[f"lin{j}"] = {
            "kernel": np.ascontiguousarray(sd[f"{prefix}{idx}.weight"].T),
            "bias": sd[f"{prefix}{idx}.bias"],
        }
    return out


def head_dims_from_params(head_params: Mapping) -> tuple[int, ...]:
    """Projection-head layer widths in the canonical ``lin{i}`` numeric
    order this importer creates — the ONE rule for rebuilding a
    ProjectionHead from checkpoint params (a lexicographic sort would
    order lin10 before lin2)."""
    keys = sorted(
        (k for k in head_params if k.startswith("lin")),
        key=lambda s: int(s[3:]),
    )
    return tuple(int(head_params[k]["kernel"].shape[-1]) for k in keys)


def timet_params_from_torch(sd: Mapping[str, np.ndarray]) -> dict:
    """Import a full TimeT checkpoint: backbone + head + prototypes.

    Returns a dict with keys matching the TimeT flax model collection:
    ``{"feature_extractor": {"backbone": ..., "head": ...}, "prototypes": ...}``.
    """
    backbone_sd = {
        k[len("feature_extractor.backbone."):]: v
        for k, v in sd.items()
        if k.startswith("feature_extractor.backbone.")
    }
    out: dict = {
        "feature_extractor": {"backbone": vit_params_from_torch(backbone_sd)}
    }
    head = head_params_from_torch(sd)
    if head:
        out["feature_extractor"]["head"] = head
    if "prototypes" in sd:
        out["prototypes"] = sd["prototypes"]
    return out
