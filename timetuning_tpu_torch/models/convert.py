"""Carry JAX parameters over to the port.

``vit_state_dict_from_jax`` turns a Flax ``VisionTransformer`` params tree
into the timm/DINO state dict that ``VisionTransformer.load_state_dict``
takes, through the JAX package's own exporter
(``timetuning_tpu/models/export_torch.vit_params_to_torch``, numpy only);
``linear_probe_head_state_dict_from_jax`` does the same for the Flax
``LinearProbeHead``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from timetuning_tpu_torch._host import host_module


def vit_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    export = host_module("models.export_torch")
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
        for k, v in export.vit_params_to_torch(params).items()
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
