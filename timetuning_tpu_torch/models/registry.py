"""Backbone zoo: ``get_backbone`` over every architecture of the JAX
registry, each one's weight import, and the released-weight table.

Counterpart of ``timetuning_tpu/models/registry.py`` (reference
models.py:773-900 ``get_backbone``, models.py:76 ``spatial_resolutions``,
leopart.py:151-230 the released-weight URLs): the 13 reference
architectures and the two test ViTs, with the JAX package's feature dims,
patch sizes, ``drop_cls`` and fixed grids, and the port's own
``dinov2-g14-reg`` (DINOv2 ViT-g/14 with registers, which the JAX package
lacks; its checkpoint in the hub's layout: ``register_tokens``,
``blocks.i.ls1.gamma``, ``mlp.w12``, ``mlp.w3``, ``mask_token`` ignored) and
``dinov3-vit7b16`` (DINOv3 ViT-7B/16; the hub's layout: ``storage_tokens``,
``rope_embed.periods`` where the file has it, ``blocks.i.mlp.w1`` / ``w2`` /
``w3``, no qkv bias, no ``pos_embed``, ``mask_token`` ignored) and
``sam-vit-h`` (the image encoder of Segment Anything ViT-H, models/sam.py;
the release's layout: the ``image_encoder.`` keys, the prompt encoder and
mask decoder ignored; no CLS token, features the neck's 256 channels, SAM's
pixel std, ImageNet's 0.229, in ``Backbone.norm_std``). ``depth``
builds the first ``depth`` blocks of a ViT (a pipeline stage's worth of a
model too large to serve whole); a checkpoint with fewer blocks than are
built raises. There is no download: every
entry takes a local ``model_path`` in the reference layout, and without one
the weights are a seeded random init. A module's ``forward(x [B, H, W, 3])``
returns the ViT's dict (``tokens``, ``attention``, ``grid``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from timetuning_tpu_torch.models.vit import (
    ViTConfig,
    VisionTransformer,
    dinov2_giant_reg,
    dinov3_vit7b,
    rope_periods,
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

# The reference's table (models.py:76); the resnet values describe its
# 448-input CBFE configuration. ``Backbone.spatial_resolution`` computes the
# grid from the architecture instead.
REFERENCE_SPATIAL_RESOLUTIONS = {
    "resnet18": 14, "resnet50": 14, "dino": 14, "stego": 28, "leopart": 14,
    "vit": 14,
}

# Released weights (leopart.py:151-216): provenance only, nothing is fetched.
PRETRAINED_URLS = {
    "dino-s16": "https://dl.fbaipublicfiles.com/dino/dino_deitsmall16_pretrain/dino_deitsmall16_pretrain.pth",
    "dino-s8": "https://dl.fbaipublicfiles.com/dino/dino_deitsmall8_pretrain/dino_deitsmall8_pretrain.pth",
    "dino-b16": "https://dl.fbaipublicfiles.com/dino/dino_vitbase16_pretrain/dino_vitbase16_pretrain.pth",
    "mocov3-s16": "https://dl.fbaipublicfiles.com/moco-v3/vit-s-300ep/vit-s-300ep.pth.tar",
    "mocov3-b16": "https://dl.fbaipublicfiles.com/moco-v3/vit-b-300ep/vit-b-300ep.pth.tar",
    "mae": "https://dl.fbaipublicfiles.com/mae/pretrain/mae_pretrain_vit_base.pth",
    "msn-s16": "https://dl.fbaipublicfiles.com/msn/vits16_800ep.pth.tar",
    "swav": "https://dl.fbaipublicfiles.com/deepcluster/swav_800ep_pretrain.pth.tar",
    "resnet18": "https://download.pytorch.org/models/resnet18-5c106cde.pth",
    "resnet50": "https://download.pytorch.org/models/resnet50-19c8e357.pth",
}

ARCHITECTURES = (
    "resnet18", "resnet50", "swav", "vit-tiny-test", "vit-tiny-test-p4",
    "dino-s16", "msn-s16", "ibot-s16", "leopart", "dino-s8", "dino-b16", "vit",
    "mocov3-s16", "mocov3-b16", "mae", "motion_grouping", "dul", "stego",
)
# the port's names beyond the JAX registry's (``ARCHITECTURES`` mirrors it)
PORT_ARCHITECTURES = ("dinov2-g14-reg", "dinov3-vit7b16", "sam-vit-h")
ALL_ARCHITECTURES = ARCHITECTURES + PORT_ARCHITECTURES
VIT_NAMES = ("vit-tiny-test", "vit-tiny-test-p4", "dino-s16", "msn-s16", "ibot-s16",
             "leopart", "dino-s8", "dino-b16", "vit", "mocov3-s16", "mocov3-b16",
             "dinov2-g14-reg", "dinov3-vit7b16")


@dataclasses.dataclass
class Backbone:
    """A ready-to-apply backbone: module + metadata. ``fixed_resolution``:
    the token grid the reference recipe pins whatever the input size
    (motion_grouping 56, dul 28; models.py:1055-1068)."""

    module: nn.Module
    patch_size: int | None
    feature_dim: int
    drop_cls: bool
    name: str
    fixed_resolution: int | None = None
    # the std of the eval preprocess's normalisation, where the backbone was
    # trained with another than the TimeT pipeline's (None: that one)
    norm_std: tuple | None = None

    def spatial_resolution(self, input_size: int = 224) -> int:
        if self.fixed_resolution is not None:
            return self.fixed_resolution
        if self.patch_size is not None:
            return input_size // self.patch_size
        return input_size // 32  # a ResNet's output stride

    def apply(self, frames, want_attention: bool = False):
        out = self.module(frames, want_attention=want_attention)
        feats = out["tokens"]
        if self.drop_cls:
            feats = feats[:, 1:]
        return feats, out.get("attention")


def _vit_config(name: str, dtype: torch.dtype) -> ViTConfig:
    from timetuning_tpu_torch.models.moco import moco_vit_base, moco_vit_small

    # the test ViTs run the plain blocks in either dtype, as the JAX
    # registry builds them (attn_impl="xla"): 16-wide heads and D = 32
    # are below what the block kernels take
    tiny = dict(embed_dim=32, depth=2, num_heads=2, img_size=32, dtype=dtype,
                attn_impl="xla")
    if name == "vit-tiny-test":
        return ViTConfig(patch_size=8, **tiny)
    if name == "vit-tiny-test-p4":
        return ViTConfig(patch_size=4, **tiny)
    if name in ("dino-s16", "msn-s16", "ibot-s16", "leopart"):
        return vit_small(16, dtype=dtype)
    if name == "dino-s8":
        return vit_small(8, dtype=dtype)
    if name in ("dino-b16", "vit"):
        return vit_base(16, dtype=dtype)
    if name == "dinov2-g14-reg":
        return dinov2_giant_reg(dtype=dtype)
    if name == "dinov3-vit7b16":
        return dinov3_vit7b(dtype=dtype)
    if name == "mocov3-s16":
        return moco_vit_small(dtype=dtype)
    return moco_vit_base(dtype=dtype)


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


def load_checked(module: nn.Module, sd: dict, only_known: bool = False,
                 assign: bool = False) -> None:
    """``module.load_state_dict(sd)``, where BatchNorm's
    ``num_batches_tracked`` may be absent; ``only_known`` drops keys the
    module does not have (a checkpoint's heads and probes) first;
    ``assign`` makes the file's tensors, in the module's dtypes, the
    parameters (a module built on the meta device)."""
    own = module.state_dict()
    if only_known:
        sd = {k: v for k, v in sd.items() if k in own}
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    unexpected = [k for k in sd if k not in own]
    if missing or unexpected:
        raise KeyError(f"checkpoint does not fit {type(module).__name__}: missing "
                       f"{missing[:8]}, unexpected {unexpected[:8]}")
    if assign:
        sd = {k: v.to(own[k].dtype).contiguous() for k, v in sd.items()}
    module.load_state_dict(sd, strict=False, assign=assign)


def seeded_init(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights for the zoo's non-ViT modules: LeCun-normal
    (truncated at two deviations) convolution and dense weights, zero
    biases, unit norm scales; BatchNorm running mean 0 and variance 1; any
    other parameter normal with std 0.02."""
    with torch.no_grad():
        done = set()
        for mod in module.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                std = mod.weight[0].numel() ** -0.5
                nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, (nn.BatchNorm2d, nn.BatchNorm1d, nn.LayerNorm,
                                  nn.GroupNorm)):
                if getattr(mod, "weight", None) is not None:
                    nn.init.ones_(mod.weight)
                    nn.init.zeros_(mod.bias)
                if getattr(mod, "running_mean", None) is not None:
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
            else:
                continue
            done.update(id(p) for p in mod.parameters(recurse=False))
        for p in module.parameters():
            if id(p) not in done:
                nn.init.normal_(p, std=0.02, generator=generator)
    return module


def _build(name: str, model_path: str | None, dtype: torch.dtype, seed: int,
           depth: int | None = None) -> Backbone:
    from timetuning_tpu_torch.models.import_torch import load_torch_state_dict, strip_prefixes

    gen = torch.Generator().manual_seed(seed)
    if depth is not None and name not in VIT_NAMES:
        raise ValueError(f"get_backbone: depth applies to the ViTs, not {name!r}")
    if name in ("resnet18", "resnet50", "swav"):
        from timetuning_tpu_torch.models import resnet

        module = resnet.resnet18(dtype) if name == "resnet18" else resnet.resnet50(dtype)
        if model_path:
            load_checked(module, resnet.resnet_state_dict_from_torch(
                load_torch_state_dict(model_path)))
        else:
            seeded_init(module, gen)
        return Backbone(module, None, module.out_dim, False, name)

    if name in VIT_NAMES:
        cfg = _vit_config(name, dtype)
        if depth is not None:
            if not 1 <= depth <= cfg.depth:
                raise ValueError(f"get_backbone: depth {depth} of {name!r}'s {cfg.depth} blocks")
            cfg = dataclasses.replace(cfg, depth=depth)
        if model_path:
            # built without an init (every parameter is the file's: 1.14 B of
            # them for DINOv2 ViT-g); head weights of a TimeT.pth share the
            # file and are not the ViT's, nor are blocks past ``depth``
            sd = load_vit_state_dict(model_path)
            if cfg.rope_base and "rope_embed.periods" not in sd:
                sd["rope_embed.periods"] = rope_periods(cfg.embed_dim // cfg.num_heads,
                                                        cfg.rope_base)
            with torch.device("meta"):
                module = VisionTransformer(cfg)
            load_checked(module, sd, only_known=True, assign=True)
        else:
            module = VisionTransformer(cfg)
            module.init_weights(gen)
        return Backbone(module, cfg.patch_size, cfg.embed_dim, True, name)

    if name == "sam-vit-h":
        from timetuning_tpu_torch.data.transforms import IMAGENET_STD
        from timetuning_tpu_torch.models.sam import SamImageEncoder, sam_state_dict, sam_vit_h

        cfg = sam_vit_h(dtype=dtype)
        if model_path:
            with torch.device("meta"):
                module = SamImageEncoder(cfg)
            load_checked(module, sam_state_dict(load_vit_state_dict(model_path)),
                         only_known=True, assign=True)
        else:
            module = SamImageEncoder(cfg).init_weights(gen)
        return Backbone(module, cfg.patch_size, cfg.out_chans, False, name,
                        norm_std=IMAGENET_STD)

    if name == "mae":
        from timetuning_tpu_torch.models.mae import mae_vit_base

        module = seeded_init(mae_vit_base(dtype=dtype), gen)
        if model_path:
            # the encoder's keys (timm layout) onto the seeded module: the
            # released file's fixed sin-cos tables and the decoder stay out
            sd = strip_prefixes(load_torch_state_dict(model_path))
            own = module.state_dict()
            enc = {k: torch.as_tensor(v) for k, v in sd.items()
                   if not k.startswith("decoder") and k != "mask_token" and k in own}
            module.load_state_dict(enc, strict=False)
        return Backbone(module, 16, 768, True, name)

    if name == "motion_grouping":
        from timetuning_tpu_torch.models.slot_attention import (
            MotionGroupingBackbone,
            motion_grouping_encoder_from_torch,
        )

        module = seeded_init(MotionGroupingBackbone(), gen)
        if model_path:
            # reference models.py:876-884: the autoencoder's checkpoint; the
            # features read its encoder_cnn
            load_checked(module, motion_grouping_encoder_from_torch(
                load_torch_state_dict(model_path)))
        return Backbone(module, None, 256, False, name, fixed_resolution=56)

    if name == "dul":
        from timetuning_tpu_torch.models.dul import DulBackbone, dul_state_dict_from_torch

        module = DulBackbone(dtype)
        if model_path:
            # reference models.py:885-894: torch.load(path)['model'], module.
            # stripped; the features are fast_net.backbone's
            load_checked(module, dul_state_dict_from_torch(load_torch_state_dict(model_path)))
        else:
            seeded_init(module, gen)
        return Backbone(module, None, 512, False, name, fixed_resolution=28)

    if name == "stego":
        # STEGO's featurizer (ViT-S/8 + the cluster projection); the
        # reference wrapped the external release (models.py:872-875)
        from timetuning_tpu_torch.models.stego import StegoFeaturizer, stego_state_dict_from_torch

        dim, sd = 70, None
        if model_path:
            sd = stego_state_dict_from_torch(load_torch_state_dict(model_path))
            dim = sd["cluster1.weight"].shape[0]
        module = StegoFeaturizer(VisionTransformer(vit_small(8, dtype=dtype)), dim)
        if sd is not None:
            load_checked(module, sd, only_known=True)
        else:
            module.backbone.init_weights(gen)
            seeded_init(module.cluster1, gen)
            seeded_init(module.cluster2_fc1, gen)
            seeded_init(module.cluster2_fc2, gen)
        # patch 8: grid 28 at 224 (models.py:76); the tokens are CLS-free
        return Backbone(module, 8, dim, False, name)

    raise ValueError(f"unknown backbone {name!r}; the zoo has {list(ALL_ARCHITECTURES)}")


def get_backbone(name: str, model_path: str | None = None,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda", seed: int = 0,
                 depth: int | None = None) -> Backbone:
    """Build backbone ``name`` on ``device``, the card unless the caller
    names the host (``device="cpu"``); with no card a CUDA device raises.
    With ``model_path`` the reference-layout weights load as the JAX
    registry reads them; without, the weights are a seeded random init.
    ``depth`` (a ViT's): build only its first ``depth`` blocks, then the
    final norm; None builds the published depth."""
    key = name.lower()
    if key not in ALL_ARCHITECTURES:
        raise ValueError(f"unknown backbone {name!r}; the zoo has {list(ALL_ARCHITECTURES)}")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "get_backbone: no CUDA device found (torch.cuda.is_available() is "
            "false); pass device='cpu' to build on the host")
    bb = _build(key, model_path, dtype, seed, depth)
    bb.module = bb.module.to(device).eval()
    return bb


def get_backbone_weights(arch: str) -> str:
    """The released weights' URL (reference leopart.py:151-216); download it
    elsewhere and pass the local path to ``get_backbone``."""
    if arch not in PRETRAINED_URLS:
        raise KeyError(f"no released weights recorded for {arch!r}")
    return PRETRAINED_URLS[arch]
