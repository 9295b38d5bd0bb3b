"""Carry JAX ViT parameters over to the port.

``vit_state_dict_from_jax`` turns a Flax ``VisionTransformer`` params tree
into the timm/DINO state dict that ``VisionTransformer.load_state_dict``
takes, through the JAX package's own exporter
(``timetuning_tpu/models/export_torch.vit_params_to_torch``, numpy only).
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
