"""Carry JAX parameters over to the port, and back.

``vit_state_dict_from_jax`` turns a Flax ``VisionTransformer`` params tree
into the timm/DINO state dict that ``VisionTransformer.load_state_dict``
takes, through the exporter (``models/export_torch.vit_params_to_torch``,
numpy only); ``linear_probe_head_state_dict_from_jax`` does the same for the
Flax ``LinearProbeHead``. ``timet_state_dict_from_jax`` carries a whole
``TimeT`` tree (backbone, projection head, prototypes) into the port's
``TimeT`` module, and ``timet_params_to_jax`` takes a state dict of that
module back to numpy arrays in the JAX tree's layout, so two trees can be
compared leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from timetuning_tpu_torch.models.export_torch import vit_params_to_torch


def vit_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
        for k, v in vit_params_to_torch(params).items()
    }


def linear_probe_head_state_dict_from_jax(
        params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax ``LinearProbeHead`` params (``conv.kernel`` [1, 1, D, C],
    ``conv.bias`` [C]) -> the port head's state dict (``conv.weight``
    [C, D, 1, 1], ``conv.bias``)."""
    kernel = np.asarray(params["conv"]["kernel"], dtype=np.float32)
    bias = np.asarray(params["conv"]["bias"], dtype=np.float32)
    return {"conv.weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
            "conv.bias": torch.from_numpy(bias.copy())}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def timet_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax ``TimeT`` params (``feature_extractor.{backbone, head}``,
    ``prototypes``) -> the port ``TimeT``'s state dict: the backbone through
    the exporter, ``head.lin{i}`` kernels [in, out] -> weights [out, in]."""
    fe = params["feature_extractor"]
    sd = {f"feature_extractor.backbone.{k}": v
          for k, v in vit_state_dict_from_jax(fe["backbone"]).items()}
    for name, lin in fe.get("head", {}).items():
        sd[f"feature_extractor.head.{name}.weight"] = _tensor(
            np.asarray(lin["kernel"]).T)
        sd[f"feature_extractor.head.{name}.bias"] = _tensor(lin["bias"])
    if "prototypes" in params:
        sd["prototypes"] = _tensor(params["prototypes"])
    return sd


def timet_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """The inverse of ``timet_state_dict_from_jax``: a (possibly partial)
    state dict of the port's ``TimeT`` -> a nested dict of numpy arrays in
    the Flax tree's layout (``blocks_{i}``, ``kernel`` [in, out], ``scale``,
    the patch kernel [p, p, 3, D])."""
    tree: dict[str, Any] = {}

    def put(path, value):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    for name, t in state_dict.items():
        a = t.detach().cpu().float().numpy()
        segs = name.split(".")
        if segs[-2:-1] == ["proj"] and "patch_embed" in segs:
            segs = segs[:-2] + segs[-1:]              # patch_embed.proj.* -> patch_embed.*
            if segs[-1] == "weight":
                a = a.transpose(2, 3, 1, 0)
        elif segs[-1] == "weight" and a.ndim == 2:
            a = a.T
        if "blocks" in segs:
            i = segs.index("blocks")
            segs = segs[:i] + [f"blocks_{segs[i + 1]}"] + segs[i + 2:]
        if segs[-1] == "weight":
            is_norm = segs[-2].startswith("norm")
            segs[-1] = "scale" if is_norm else "kernel"
        put(segs, np.ascontiguousarray(a))
    return tree
