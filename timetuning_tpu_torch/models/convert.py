"""Carry JAX parameters over to the port, and back.

``vit_state_dict_from_jax`` turns a Flax ``VisionTransformer`` params tree
into the timm/DINO state dict that ``VisionTransformer.load_state_dict``
takes, through the exporter (``models/export_torch.vit_params_to_torch``,
numpy only); ``linear_probe_head_state_dict_from_jax`` does the same for the
Flax ``LinearProbeHead``. ``timet_state_dict_from_jax`` carries a whole
``TimeT`` tree (backbone, projection head, prototypes) into the port's
``TimeT`` module, and ``timet_params_to_jax`` takes a state dict of that
module back to numpy arrays in the JAX tree's layout, so two trees can be
compared leaf by leaf. Both directions carry MoE blocks: the router's flax
``kernel`` [D, E] is the port's ``router.weight`` [E, D], the stacked expert
leaves are carried as they are.

The zoo's other families go through ``flax_state_dict``, one Flax variables
tree (``params`` and ``batch_stats``) to the port module's state dict by
name: ``resnet_state_dict_from_jax``, ``dul_state_dict_from_jax``,
``motion_grouping_state_dict_from_jax`` (the zoo's encoder or the whole
autoencoder), ``mae_state_dict_from_jax`` (encoder and decoder),
``stego_state_dict_from_jax``, ``moco_predictor_state_dict_from_jax`` and
``conv_stem_state_dict_from_jax``.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Mapping

import numpy as np
import torch

from timetuning_tpu_torch.models.export_torch import vit_params_to_torch


def _moe_state_dict(prefix: str, moe: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """A Flax ``MoEMlp`` tree -> the port's names: the router's kernel
    [D, E] -> ``router.weight`` [E, D]; the stacked ``w1``, ``b1``, ``w2``,
    ``b2`` as they are."""
    sd = {prefix + "router.weight": np.asarray(moe["router"]["kernel"]).T}
    for leaf in ("w1", "b1", "w2", "b2"):
        sd[prefix + leaf] = np.asarray(moe[leaf])
    return sd


def vit_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A Flax ``VisionTransformer`` tree -> the port's state dict, MoE blocks
    (``blocks_i.moe``) included."""
    params = dict(params)
    moe = {}
    for k in [k for k in params if k.startswith("blocks_") and "moe" in params[k]]:
        blk = dict(params[k])
        moe.update(_moe_state_dict(f"blocks.{k.split('_')[1]}.moe.", blk.pop("moe")))
        # the exporter reads a dense MLP from every block: a stand-in that
        # is dropped again
        blk["mlp"] = {f: {"kernel": np.zeros((0, 0)), "bias": np.zeros(0)}
                      for f in ("fc1", "fc2")}
        params[k] = blk
    sd = {k: v for k, v in vit_params_to_torch(params).items()
          if not any(k.startswith(f"blocks.{b}.mlp.") for b in
                     {n.split(".")[1] for n in moe})}
    sd.update(moe)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
            for k, v in sd.items()}


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


_LEAF = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping[str, Any], prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_state_dict(variables: Mapping[str, Any],
                    rename: Callable[[list], list] = lambda segs: segs
                    ) -> dict[str, torch.Tensor]:
    """Flax variables (``params``, and ``batch_stats`` where there are
    BatchNorms) -> a state dict: a ``kernel`` becomes ``weight`` (dense [in,
    out] -> [out, in]; convolution HWIO -> OIHW), ``scale`` ``weight``,
    ``mean`` / ``var`` ``running_mean`` / ``running_var``; ``rename`` maps
    the module path's segments to the port's."""
    sd = {}
    for col in ("params", "batch_stats"):
        for path, a in _leaves(variables.get(col, {})):
            a = np.asarray(a, dtype=np.float32)
            *mods, leaf = path
            if leaf == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                leaf = "weight"
            else:
                leaf = _LEAF.get(leaf, leaf)
            sd[".".join(rename(list(mods)) + [leaf])] = torch.tensor(a)
    return sd


def _resnet_names(segs: list) -> list:
    out = []
    for s in segs:
        if s == "bn":                     # the JAX _BN wrapper's inner module
            continue
        m = re.fullmatch(r"layer(\d)_(\d+)", s)
        out += ([f"layer{m[1]}", m[2]] if m else
                ["downsample", "0"] if s == "ds_conv" else
                ["downsample", "1"] if s == "ds_bn" else [s])
    return out


def _block_names(segs: list) -> list:
    out = []
    for s in segs:
        m = re.fullmatch(r"(decoder_blocks|blocks)_(\d+)", s)
        out += [m[1], m[2]] if m else ["in_"] if s == "in" and out[-1:] == ["gru"] else [s]
    return out


def resnet_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``timetuning_tpu/models/resnet.ResNet`` variables (with their
    ``batch_stats``) -> ``models/resnet.ResNet``'s torchvision-named state dict."""
    return flax_state_dict(variables, _resnet_names)


def dul_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``DulBackbone`` variables (``net`` a stride-8 ResNet18) -> the port's."""
    return flax_state_dict(variables, _resnet_names)


def motion_grouping_state_dict_from_jax(
        variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``MotionGroupingBackbone`` or ``SlotAttentionAutoEncoder`` variables
    -> the port module's state dict (the same names; GRU ``in`` -> ``in_``)."""
    return flax_state_dict(variables, _block_names)


def mae_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``MAEViT`` variables (encoder and decoder) -> ``models/mae.MAEViT``'s
    state dict (the MAE release's names)."""
    return flax_state_dict(variables, lambda segs: ["patch_embed", "proj"]
                           if segs == ["patch_embed"] else _block_names(segs))


def stego_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``StegoFeaturizer`` variables -> the port's: the ViT through the
    exporter, the three dense heads by name."""
    params = variables["params"]
    sd = {f"backbone.{k}": v for k, v in vit_state_dict_from_jax(params["backbone"]).items()}
    sd.update(flax_state_dict({"params": {k: v for k, v in params.items()
                                          if k != "backbone"}}))
    return sd


def moco_predictor_state_dict_from_jax(
        variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``MoCoPredictor`` variables -> ``models/moco.MoCoPredictor``'s."""
    return flax_state_dict(variables)


def conv_stem_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``ConvStem`` variables -> ``models/moco.ConvStem``'s."""
    return flax_state_dict(variables)
