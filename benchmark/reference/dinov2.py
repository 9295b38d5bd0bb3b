"""The plain reference of DINOv2 with registers (``dinov2_vitg14_reg``).

Plain PyTorch in float32, from the published description (DINOv2, Oquab et
al. 2023, arXiv:2304.07193; registers, Darcet et al. 2023, arXiv:2309.16588;
``facebookresearch/dinov2``, ``dinov2/models/vision_transformer.py`` and
``dinov2/layers``):

* a patch convolution; ``[CLS; patches] + pos``, the stored grid of positions
  resized to the input's grid by size, bicubic with antialias
  (``interpolate_offset=0``, ``interpolate_antialias=True``); the learned
  registers inserted after the CLS token, with no position;
* pre-norm blocks ``x = x + ls1 * attn(LN1(x))``, ``x = x + ls2 *
  w3(silu(a) * b)`` with ``[a | b] = w12(LN2(x))`` (``SwiGLUFFNFused``: the
  first and second halves of ``w12``'s outputs), LayerNorm eps 1e-6,
  qkv / proj / FFN biases on;
* the final LayerNorm; the dense features are its patch tokens, after the
  1 + R prefix tokens.

Parameters are a flat dict in the hub checkpoint's layout (``cls_token``,
``register_tokens``, ``mask_token``, ``pos_embed``, ``patch_embed.proj``,
``blocks.i.{norm1, attn.qkv, attn.proj, ls1.gamma, norm2, mlp.w12, mlp.w3,
ls2.gamma}``, ``norm``), so one state dict serves the reference and the
program. ``mask_token`` (DINOv2's masked-image training) takes no part in a
forward.

``quant="fp8"``: both operands of every matrix product in float8 e4m3 with
a per-tensor scale (``vit.fp8``), the control. ``layerscale=False`` and
``registers=False`` leave LayerScale or the registers out: the faults a
program that dropped either would show.

Imports nothing of the program, of JAX, or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from benchmark.reference.dense import preprocess
from benchmark.reference.vit import _mm_operands, layer_norm, linear

# the draw of the LayerScale vectors: per channel, uniform in [lo, hi), away
# from 1 so that a program that drops them fails the comparison
LAYERSCALE_RANGE = (0.05, 0.5)


@dataclasses.dataclass(frozen=True)
class DinoV2Shape:
    patch: int = 14
    dim: int = 1536
    depth: int = 40
    heads: int = 24
    hidden: int = 4096           # the SwiGLU hidden (w3's input)
    registers: int = 4
    img_size: int = 518          # the grid the positions are stored at

    @classmethod
    def of(cls, config: dict) -> "DinoV2Shape":
        return cls(patch=config["patch_size"], dim=config["embed_dim"],
                   depth=config["depth"], heads=config["num_heads"],
                   hidden=config["ffn_hidden"], registers=config["n_registers"],
                   img_size=config["pos_embed_size"])


def swiglu_hidden(dim: int, mlp_ratio: float = 4.0) -> int:
    """``SwiGLUFFNFused``'s hidden: ``(int(dim * ratio * 2 / 3) + 7) // 8 * 8``."""
    return (int(dim * mlp_ratio * 2 / 3) + 7) // 8 * 8


def param_shapes(s: DinoV2Shape) -> dict:
    """Every parameter's shape, in the hub checkpoint's layout."""
    D, H = s.dim, s.hidden
    out = {"cls_token": (1, 1, D), "register_tokens": (1, s.registers, D),
           "mask_token": (1, D),
           "pos_embed": (1, 1 + (s.img_size // s.patch) ** 2, D),
           "patch_embed.proj.weight": (D, 3, s.patch, s.patch),
           "patch_embed.proj.bias": (D,)}
    for i in range(s.depth):
        b = f"blocks.{i}."
        out.update({b + "norm1.weight": (D,), b + "norm1.bias": (D,),
                    b + "attn.qkv.weight": (3 * D, D), b + "attn.qkv.bias": (3 * D,),
                    b + "attn.proj.weight": (D, D), b + "attn.proj.bias": (D,),
                    b + "ls1.gamma": (D,),
                    b + "norm2.weight": (D,), b + "norm2.bias": (D,),
                    b + "mlp.w12.weight": (2 * H, D), b + "mlp.w12.bias": (2 * H,),
                    b + "mlp.w3.weight": (D, H), b + "mlp.w3.bias": (D,),
                    b + "ls2.gamma": (D,)})
    out["norm.weight"] = (D,)
    out["norm.bias"] = (D,)
    return out


def seeded_weights(s: DinoV2Shape, seed: int, device) -> dict:
    """Weights of the given shape from ``seed``, made on ``device`` in two
    large draws: one normal draw for everything but LayerScale (matrices
    at std 1 / sqrt(fan in) truncated at 2 std, biases at std 0.02,
    LayerNorm scales 1 + 0.1 N(0, 1), CLS, registers, mask token and
    positions at std 0.02 truncated at 2 std), then the LayerScale vectors
    uniform in ``LAYERSCALE_RANGE``. In f32."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    shapes = param_shapes(s)
    normal = {k: v for k, v in shapes.items() if not k.endswith("gamma")}
    sizes = {k: math.prod(v) for k, v in normal.items()}
    flat = torch.randn(sum(sizes.values()), generator=gen, device=device)
    out, at = {}, 0
    for k, shape in normal.items():
        v = flat[at:at + sizes[k]].view(shape)
        at += sizes[k]
        if k.endswith("weight") and len(shape) > 1:
            v = v.clamp(-2.0, 2.0) * math.prod(shape[1:]) ** -0.5
        elif "norm" in k and k.endswith("weight"):
            v = 1.0 + 0.1 * v
        elif k.endswith("bias"):
            v = 0.02 * v
        else:
            v = 0.02 * v.clamp(-2.0, 2.0)
        out[k] = v.contiguous()
    del flat
    gammas = [k for k in shapes if k.endswith("gamma")]
    lo, hi = LAYERSCALE_RANGE
    u = torch.rand(len(gammas), s.dim, generator=gen, device=device) * (hi - lo) + lo
    for i, k in enumerate(gammas):
        out[k] = u[i].clone()
    return {k: out[k] for k in shapes}


def pos_embed_for(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """DINOv2's ``interpolate_pos_encoding`` (offset 0, antialias): the
    stored grid resized to (gh, gw) by size, bicubic with antialias; the
    stored positions as they are at their own grid."""
    n0 = int(round(math.sqrt(pos.shape[1] - 1)))
    if (gh, gw) == (n0, n0):
        return pos
    dim = pos.shape[-1]
    grid = pos[:, 1:].reshape(1, n0, n0, dim).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", antialias=True,
                         align_corners=False)
    return torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, dim)], dim=1)


def embed(p: dict, x: torch.Tensor, s: DinoV2Shape, registers: bool = True) -> torch.Tensor:
    """x [B, H, W, 3] f32 -> tokens [B, 1 + R + N, D]: CLS, the registers,
    the patches."""
    t = F.conv2d(x.permute(0, 3, 1, 2), p["patch_embed.proj.weight"],
                 p["patch_embed.proj.bias"], stride=s.patch)
    gh, gw = t.shape[-2:]
    t = t.flatten(2).transpose(1, 2)
    cls = p["cls_token"].expand(t.shape[0], 1, s.dim)
    t = torch.cat([cls, t], dim=1) + pos_embed_for(p["pos_embed"], gh, gw)
    if not registers:
        return t
    reg = p["register_tokens"].expand(t.shape[0], s.registers, s.dim)
    return torch.cat([t[:, :1], reg, t[:, 1:]], dim=1)


def block(p: dict, x: torch.Tensor, i: int, s: DinoV2Shape, quant=None,
          layerscale: bool = True) -> torch.Tensor:
    k = f"blocks.{i}."
    B, T, D = x.shape
    ls1 = p[k + "ls1.gamma"] if layerscale else 1.0
    ls2 = p[k + "ls2.gamma"] if layerscale else 1.0
    h = layer_norm(x, p[k + "norm1.weight"], p[k + "norm1.bias"])
    qkv = linear(h, p[k + "attn.qkv.weight"], p[k + "attn.qkv.bias"], quant)
    qkv = qkv.reshape(B, T, 3, s.heads, D // s.heads).permute(2, 0, 3, 1, 4)
    q, kk, v = qkv[0], qkv[1], qkv[2]
    q, kk = _mm_operands(q, kk, quant)
    att = torch.softmax((q * (D // s.heads) ** -0.5) @ kk.transpose(-2, -1), dim=-1)
    att, v = _mm_operands(att, v, quant)
    o = (att @ v).transpose(1, 2).reshape(B, T, D)
    x = x + ls1 * linear(o, p[k + "attn.proj.weight"], p[k + "attn.proj.bias"], quant)
    h = layer_norm(x, p[k + "norm2.weight"], p[k + "norm2.bias"])
    a, b = linear(h, p[k + "mlp.w12.weight"], p[k + "mlp.w12.bias"], quant).chunk(2, dim=-1)
    return x + ls2 * linear(F.silu(a) * b, p[k + "mlp.w3.weight"], p[k + "mlp.w3.bias"], quant)


def tokens(p: dict, x: torch.Tensor, s: DinoV2Shape, quant=None, layerscale: bool = True,
           registers: bool = True) -> torch.Tensor:
    """Every final-norm token [B, 1 + R + N, D] of images x [B, H, W, 3]
    (1 + N without the registers)."""
    t = embed(p, x, s, registers)
    for i in range(s.depth):
        t = block(p, t, i, s, quant, layerscale)
    return layer_norm(t, p["norm.weight"], p["norm.bias"])


def features(p: dict, x: torch.Tensor, s: DinoV2Shape, quant=None, layerscale: bool = True,
             registers: bool = True) -> torch.Tensor:
    """The dense features [B, N, D]: the final-norm patch tokens."""
    prefix = 1 + (s.registers if registers else 0)
    return tokens(p, x, s, quant, layerscale, registers)[:, prefix:]


@torch.no_grad()
def features_u8(p: dict, frames_u8: torch.Tensor, s: DinoV2Shape, size: int, mean, std,
                quant=None, layerscale: bool = True, registers: bool = True,
                chunk: int = 5) -> torch.Tensor:
    """The patch features [N, P, D] of uint8 frames [N, H, W, 3] through the
    eval preprocess (``dense.preprocess``), ``chunk`` frames at a time (the
    attention of 1,029 tokens over 24 heads holds 102 MB a frame), with TF32
    off for matrix products and convolutions."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = [features(p, preprocess(frames_u8[i:i + chunk], size, mean, std), s, quant,
                        layerscale, registers)
               for i in range(0, frames_u8.shape[0], chunk)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return torch.cat(out)
