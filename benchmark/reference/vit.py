"""The plain reference of the DINO ViT and TimeT's projection head.

Plain PyTorch in float32, from the published description (Dosovitskiy et
al. 2021; DINO, Caron et al. 2021, ``vision_transformer.py``): a patch
convolution, a CLS token, learned positions resized bicubically to the
input's grid (DINO's ``interpolate_pos_encoding``, with its ``+0.1``),
pre-norm blocks (LayerNorm eps 1e-6, multi-head attention, an MLP with
exact GELU), a final LayerNorm. The projection head is TimeT's MLP
(``lin0`` .. ``lin3`` with GELU between). Parameters are a flat dict under
the timm/DINO names, so one state dict serves the reference and the
program.

``quant="fp8"`` rounds both operands of every matrix product (the
projections, the attention's two products, the head) to float8 e4m3 with
a per-tensor scale and accumulates in f32: the precision below bf16, the
control that the comparison has to fail.

Imports nothing of the program, of JAX, or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ViTShape:
    patch: int = 16
    dim: int = 384
    depth: int = 12
    heads: int = 6
    mlp_ratio: float = 4.0
    img_size: int = 224          # the grid the positions are stored at

    @classmethod
    def of(cls, config: dict) -> "ViTShape":
        return cls(patch=config["patch_size"], dim=config["embed_dim"],
                   depth=config["depth"], heads=config["num_heads"],
                   mlp_ratio=config["mlp_ratio"], img_size=config["pos_embed_size"])

    @property
    def hidden(self) -> int:
        return int(self.dim * self.mlp_ratio)


def param_shapes(s: ViTShape, prefix: str = "") -> dict:
    """Every parameter's shape, in the program's registration order."""
    D, H = s.dim, s.hidden
    out = {f"{prefix}cls_token": (1, 1, D),
           f"{prefix}pos_embed": (1, 1 + (s.img_size // s.patch) ** 2, D),
           f"{prefix}patch_embed.proj.weight": (D, 3, s.patch, s.patch),
           f"{prefix}patch_embed.proj.bias": (D,)}
    for i in range(s.depth):
        b = f"{prefix}blocks.{i}."
        out.update({b + "norm1.weight": (D,), b + "norm1.bias": (D,),
                    b + "attn.qkv.weight": (3 * D, D), b + "attn.qkv.bias": (3 * D,),
                    b + "attn.proj.weight": (D, D), b + "attn.proj.bias": (D,),
                    b + "norm2.weight": (D,), b + "norm2.bias": (D,),
                    b + "mlp.fc1.weight": (H, D), b + "mlp.fc1.bias": (H,),
                    b + "mlp.fc2.weight": (D, H), b + "mlp.fc2.bias": (D,)})
    out[f"{prefix}norm.weight"] = (D,)
    out[f"{prefix}norm.bias"] = (D,)
    return out


def seeded_weights(s: ViTShape, seed: int, device) -> dict:
    """Weights of the given shape from ``seed``, made on ``device`` in a few
    large calls: one normal draw for all the matrices (std 1 / sqrt(fan
    in), truncated at 2 std), small normal biases, LayerNorm scales near 1,
    positions and CLS at std 0.02. In f32, the type the program keeps its
    parameters in."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    shapes = param_shapes(s)
    sizes = {k: math.prod(v) for k, v in shapes.items()}
    flat = torch.randn(sum(sizes.values()), generator=gen, device=device)
    out, at = {}, 0
    for k, shape in shapes.items():
        v = flat[at:at + sizes[k]].view(shape)
        at += sizes[k]
        if k.endswith("weight") and len(shape) > 1:
            fan_in = math.prod(shape[1:])
            v = v.clamp(-2.0, 2.0) * fan_in ** -0.5
        elif "norm" in k and k.endswith("weight"):
            v = 1.0 + 0.1 * v
        elif k.endswith("bias"):
            v = 0.02 * v
        else:
            v = 0.02 * v.clamp(-2.0, 2.0)
        out[k] = v.contiguous()
    return out


# --------------------------------------------------------------------- #
# the program's own seeded init, re-drawn (TimeT's init from a seed)

def _trunc(shape, std, gen, a=None, b=None):
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, std=std, a=-2.0 if a is None else a,
                                b=2.0 if b is None else b, generator=gen)
    return t


def timet_init(s: ViTShape, head_dims, n_prototypes: int, seed: int) -> dict:
    """The weights a TimeT model draws from ``seed``: the ViT's truncated
    normals (CLS and positions at std 0.02, each projection and the patch
    kernel at 1 / sqrt(fan in) truncated at 2 std, zero biases, unit
    LayerNorms), the head's LeCun normals (std 1 / sqrt(fan in) / 0.8796,
    truncated at 2 std), the prototypes' normal rows made unit-norm; all
    from one CPU generator in this order."""
    gen = torch.Generator().manual_seed(int(seed))
    bb = "feature_extractor.backbone."
    shapes = param_shapes(s, bb)
    out = {bb + "cls_token": _trunc(shapes[bb + "cls_token"], 0.02, gen),
           bb + "pos_embed": _trunc(shapes[bb + "pos_embed"], 0.02, gen)}
    # the modules' order: the patch kernel, then each block's qkv, proj,
    # fc1, fc2 (LayerNorms and biases draw nothing)
    for k, shape in shapes.items():
        if k in out:
            continue
        if k.endswith("weight") and len(shape) > 1:
            fan_in = math.prod(shape[1:])
            std = fan_in ** -0.5
            out[k] = _trunc(shape, std, gen, -2 * std, 2 * std)
        elif "norm" in k and k.endswith("weight"):
            out[k] = torch.ones(shape)
        else:
            out[k] = torch.zeros(shape)
    dims = (s.dim, *head_dims)
    for i in range(len(head_dims)):
        std = dims[i] ** -0.5 / 0.87962566103423978
        out[f"feature_extractor.head.lin{i}.weight"] = _trunc(
            (dims[i + 1], dims[i]), std, gen, -2 * std, 2 * std)
        out[f"feature_extractor.head.lin{i}.bias"] = torch.zeros(dims[i + 1])
    p = torch.randn((n_prototypes, head_dims[-1]), generator=gen)
    out["prototypes"] = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-12)
    return out


# --------------------------------------------------------------------- #
# the forward

def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in f32; the
    gradient passes through the rounding unchanged (the backward's products
    then read the rounded operands)."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x.detach())


def _mm_operands(a, b, quant):
    if quant == "fp8":
        return fp8(a), fp8(b)
    return a, b


def linear(x, w, b, quant=None):
    x, w = _mm_operands(x, w, quant)
    return F.linear(x, w, b)


def layer_norm(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps=1e-6)


def pos_embed_for(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """DINO's ``interpolate_pos_encoding``: the stored grid resized
    bicubically to (gh, gw) with scale factors ``(g + 0.1) / n0``."""
    n = pos.shape[1] - 1
    n0 = int(round(math.sqrt(n)))
    if (gh, gw) == (n0, n0):
        return pos
    dim = pos.shape[-1]
    grid = pos[:, 1:].reshape(1, n0, n0, dim).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((gh + 0.1) / n0, (gw + 0.1) / n0),
                         mode="bicubic", align_corners=False)
    if grid.shape[-2:] != (gh, gw):
        raise ValueError(f"position grid {tuple(grid.shape[-2:])} != ({gh}, {gw})")
    return torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, dim)], dim=1)


def embed(p: dict, x: torch.Tensor, s: ViTShape, prefix: str = "") -> torch.Tensor:
    """x [B, H, W, 3] f32 -> tokens [B, 1 + N, D] (CLS first)."""
    w, b = p[prefix + "patch_embed.proj.weight"], p[prefix + "patch_embed.proj.bias"]
    t = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=s.patch)
    gh, gw = t.shape[-2:]
    t = t.flatten(2).transpose(1, 2)
    cls = p[prefix + "cls_token"].expand(t.shape[0], 1, s.dim)
    return torch.cat([cls, t], dim=1) + pos_embed_for(p[prefix + "pos_embed"], gh, gw)


def block(p: dict, x: torch.Tensor, i: int, s: ViTShape, prefix: str = "",
          quant=None) -> torch.Tensor:
    k = f"{prefix}blocks.{i}."
    B, T, D = x.shape
    h = layer_norm(x, p[k + "norm1.weight"], p[k + "norm1.bias"])
    qkv = linear(h, p[k + "attn.qkv.weight"], p[k + "attn.qkv.bias"], quant)
    qkv = qkv.reshape(B, T, 3, s.heads, D // s.heads).permute(2, 0, 3, 1, 4)
    q, kk, v = qkv[0], qkv[1], qkv[2]
    q, kk = _mm_operands(q, kk, quant)
    att = torch.softmax((q * (D // s.heads) ** -0.5) @ kk.transpose(-2, -1), dim=-1)
    att, v = _mm_operands(att, v, quant)
    o = (att @ v).transpose(1, 2).reshape(B, T, D)
    x = x + linear(o, p[k + "attn.proj.weight"], p[k + "attn.proj.bias"], quant)
    h = layer_norm(x, p[k + "norm2.weight"], p[k + "norm2.bias"])
    h = F.gelu(linear(h, p[k + "mlp.fc1.weight"], p[k + "mlp.fc1.bias"], quant))
    return x + linear(h, p[k + "mlp.fc2.weight"], p[k + "mlp.fc2.bias"], quant)


def blocks(p: dict, x: torch.Tensor, s: ViTShape, start: int, stop: int,
           prefix: str = "", quant=None) -> torch.Tensor:
    for i in range(start, stop):
        x = block(p, x, i, s, prefix, quant)
    return x


def final_norm(p: dict, x: torch.Tensor, prefix: str = "") -> torch.Tensor:
    """The final LayerNorm, the CLS token dropped: patch features [B, N, D]."""
    return layer_norm(x, p[prefix + "norm.weight"], p[prefix + "norm.bias"])[:, 1:]


def features(p: dict, x: torch.Tensor, s: ViTShape, quant=None) -> torch.Tensor:
    """The dense features of images x [B, H, W, 3]: [B, N, D]."""
    return final_norm(p, blocks(p, embed(p, x, s), s, 0, s.depth, quant=quant))


def head(p: dict, x: torch.Tensor, n_layers: int, prefix: str, quant=None) -> torch.Tensor:
    for i in range(n_layers):
        x = linear(x, p[f"{prefix}lin{i}.weight"], p[f"{prefix}lin{i}.bias"], quant)
        if i != n_layers - 1:
            x = F.gelu(x)
    return x
