# The port's own copy of timetuning_tpu/models/export_torch.py (host code: numpy, no JAX), with its
# imports of the package renamed; tests/test_torch_host_copies.py pins it to the original.
"""JAX → PyTorch checkpoint export (the inverse of import_torch).

Writes the published ``TimeT.pth`` layout (reference README.md:66-76 and
``TimeT.save``, time_tuning.py:219-220): keys
``feature_extractor.backbone.<timm vit_small_patch16_224 key>`` plus the
projection-head Sequential indices (models.py:914-926: Linears at 0,2,4,6)
and the ``prototypes`` bank — so checkpoints trained HERE load directly
into the reference codebase (or any timm consumer, after prefix stripping).

Layout conversions are the exact inverses of import_torch:
  * Linear:   kernel [in, out]        → weight [out, in]   (transpose)
  * Conv2d:   kernel [kh, kw, I, O]   → weight [O, I, kh, kw]
  * LayerNorm: scale/bias             → weight/bias
Round-trip identity (export → import == identity) is tested in
tests/test_timet_import.py.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np


def _np(x) -> np.ndarray:
    return np.asarray(x)


def vit_params_to_torch(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Flax VisionTransformer params → timm-style torch state dict keys."""

    def t(k):  # linear kernel → torch weight
        return np.ascontiguousarray(_np(k).T)

    sd: dict[str, np.ndarray] = {
        "cls_token": _np(params["cls_token"]),
        "pos_embed": _np(params["pos_embed"]),
        "patch_embed.proj.weight": np.ascontiguousarray(
            np.transpose(_np(params["patch_embed"]["kernel"]), (3, 2, 0, 1))
        ),
        "patch_embed.proj.bias": _np(params["patch_embed"]["bias"]),
    }
    blocks = sorted(
        (int(k.split("_")[1]), k) for k in params if k.startswith("blocks_")
    )
    for i, key in blocks:
        blk = params[key]
        b = f"blocks.{i}."
        sd[b + "norm1.weight"] = _np(blk["norm1"]["scale"])
        sd[b + "norm1.bias"] = _np(blk["norm1"]["bias"])
        sd[b + "norm2.weight"] = _np(blk["norm2"]["scale"])
        sd[b + "norm2.bias"] = _np(blk["norm2"]["bias"])
        sd[b + "attn.qkv.weight"] = t(blk["attn"]["qkv"]["kernel"])
        if "bias" in blk["attn"]["qkv"]:
            sd[b + "attn.qkv.bias"] = _np(blk["attn"]["qkv"]["bias"])
        sd[b + "attn.proj.weight"] = t(blk["attn"]["proj"]["kernel"])
        sd[b + "attn.proj.bias"] = _np(blk["attn"]["proj"]["bias"])
        sd[b + "mlp.fc1.weight"] = t(blk["mlp"]["fc1"]["kernel"])
        sd[b + "mlp.fc1.bias"] = _np(blk["mlp"]["fc1"]["bias"])
        sd[b + "mlp.fc2.weight"] = t(blk["mlp"]["fc2"]["kernel"])
        sd[b + "mlp.fc2.bias"] = _np(blk["mlp"]["fc2"]["bias"])
    sd["norm.weight"] = _np(params["norm"]["scale"])
    sd["norm.bias"] = _np(params["norm"]["bias"])
    return sd


def head_params_to_torch(
    head: Mapping[str, Any], prefix: str = "feature_extractor.head."
) -> dict[str, np.ndarray]:
    """ProjectionHead lin0..linN → the reference's nn.Sequential indices
    (Linear at even slots, GELU between: 0, 2, 4, ...)."""
    sd = {}
    layers = sorted(int(k[len("lin"):]) for k in head if k.startswith("lin"))
    for j in layers:
        sd[f"{prefix}{2 * j}.weight"] = np.ascontiguousarray(
            _np(head[f"lin{j}"]["kernel"]).T
        )
        sd[f"{prefix}{2 * j}.bias"] = _np(head[f"lin{j}"]["bias"])
    return sd


def timet_state_dict(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Full TimeT params tree → the published TimeT.pth key layout."""
    fe = params["feature_extractor"]
    sd = {
        "feature_extractor.backbone." + k: v
        for k, v in vit_params_to_torch(fe["backbone"]).items()
    }
    if "head" in fe:
        sd.update(head_params_to_torch(fe["head"]))
    if "prototypes" in params:
        sd["prototypes"] = _np(params["prototypes"])
    return sd


def exportable(params: Mapping[str, Any]) -> bool:
    """True when the tree follows the TimeT-over-ViT layout this exporter
    understands (anything else — ResNet/STEGO/... backbones — falls back to
    the Orbax export)."""
    try:
        fe = params["feature_extractor"]
        bb = fe["backbone"]
    except (KeyError, TypeError):
        return False
    if not ("cls_token" in bb and "patch_embed" in bb):
        return False
    # every feature_extractor subtree must be one the exporter serializes —
    # a dual-head tree (FeatureExtractorV2: segmentation/propagation heads)
    # would otherwise export a .pth silently missing its trained heads
    return all(k in ("backbone", "head") for k in fe)


def save_timet_pth(params: Mapping[str, Any], path: str) -> str:
    """Write a reference-loadable ``.pth`` (torch.save of float32 tensors)."""
    import torch

    sd = {
        # copy=True: jax arrays view as READ-ONLY numpy; from_numpy on a
        # non-writable array is undefined behavior (torch warns)
        k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
        for k, v in timet_state_dict(params).items()
    }
    torch.save(sd, path)
    return path
