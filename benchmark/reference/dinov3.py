"""The plain reference of DINOv3 ViT-7B/16 (``dinov3_vit7b16``), the first
``depth`` of its 40 blocks.

Plain PyTorch in float32, from the published description (DINOv3, Simeoni
et al. 2025, arXiv:2508.10104; ``facebookresearch/dinov3``,
``dinov3/models/vision_transformer.py``, ``dinov3/layers/attention.py``,
``rope_position_encoding.py``, ``ffn_layers.py``):

* a patch convolution; ``[CLS; 4 storage tokens; patches]``, no learned
  position;
* pre-norm blocks ``x = x + ls1 * proj(attn(LN1(x)))``, ``x = x + ls2 *
  w3(silu(w1 h) * w2 h)`` with ``h = LN2(x)``; LayerNorm eps 1e-5; qkv
  without a bias, proj and the three FFN products with one;
* 2-D axial RoPE on q and k of the patch tokens only: patch (r, c) of an
  h x w grid at y = 2 (r + 1/2) / h - 1, x = 2 (c + 1/2) / w - 1, periods
  p_j = base^(j / (Dh / 4)) (``rope_embed.periods``), angles ``[2 pi y /
  p_j ..., 2 pi x / p_j ...]`` tiled twice to Dh, ``rope(u) = u cos + rot(u)
  sin`` with ``rot(u) = [-u[Dh/2:], u[:Dh/2]]``; the prefix tokens and v
  unrotated; no jitter, shift or rescale (training augmentations);
* the final LayerNorm over every token; the dense features are the patch
  tokens after the 1 + 4 prefix tokens.

Departures, each a consequence of the cut or of the runs: only the first
``depth`` blocks are built, and the final norm follows them (a pipeline
stage's output normed as the whole model's would be); the attention is
computed a frame and ``head_group`` heads at a time (the same arithmetic as
one softmax over the frame's tokens: 3,141 tokens x 32 heads would hold 1.3
GB a frame); ``mask_token`` (masked-image training) takes no part.

Parameters are a flat dict in the hub checkpoint's layout (``cls_token``,
``storage_tokens``, ``mask_token``, ``patch_embed.proj``,
``rope_embed.periods``, ``blocks.i.{norm1, attn.qkv.weight, attn.proj,
ls1.gamma, norm2, mlp.w1, mlp.w2, mlp.w3, ls2.gamma}``, ``norm``), so one
state dict serves the reference and the program.

``quant="fp8"``: both operands of every matrix product in float8 e4m3 with
a per-tensor scale (``vit.fp8``), the control. ``fault``: ``no_rope`` (q and
k unrotated), ``rope_on_prefix`` (the table laid over the tokens from the
first: the prefix rotated by the first five rows' angles, each patch by
those of the patch five before it, the last five patches unrotated) and
``no_layerscale``: what a program with such a fault would give.

Imports nothing of the program, of JAX, or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from benchmark.reference.dense import preprocess
from benchmark.reference.vit import _mm_operands, linear

LN_EPS = 1e-5
# the draw of the LayerScale vectors: per channel, uniform in [lo, hi), away
# from 1 so that a program that drops them fails the comparison
LAYERSCALE_RANGE = (0.05, 0.5)
FAULTS = ("no_rope", "rope_on_prefix", "no_layerscale")


@dataclasses.dataclass(frozen=True)
class DinoV3Shape:
    patch: int = 16
    dim: int = 4096
    depth: int = 10
    heads: int = 32
    hidden: int = 8192           # the SwiGLU hidden (w3's input)
    registers: int = 4           # storage tokens
    rope_base: float = 100.0

    @classmethod
    def of(cls, config: dict) -> "DinoV3Shape":
        return cls(patch=config["patch_size"], dim=config["embed_dim"],
                   depth=config["depth"], heads=config["num_heads"],
                   hidden=config["ffn_hidden"], registers=config["n_storage_tokens"],
                   rope_base=config["rope_base"])


def swiglu_hidden(dim: int, ffn_ratio: float = 3.0, align: int = 64) -> int:
    """``SwiGLUFFN``'s hidden ("swiglu64"): two thirds of ``dim * ffn_ratio``
    rounded up to a multiple of ``align``; 8,192 at D 4,096."""
    return (int(dim * ffn_ratio * 2 / 3) + align - 1) // align * align


def param_shapes(s: DinoV3Shape) -> dict:
    """Every parameter's shape, in the hub checkpoint's layout."""
    D, H = s.dim, s.hidden
    out = {"cls_token": (1, 1, D), "storage_tokens": (1, s.registers, D),
           "mask_token": (1, D),
           "patch_embed.proj.weight": (D, 3, s.patch, s.patch),
           "patch_embed.proj.bias": (D,),
           "rope_embed.periods": (D // s.heads // 4,)}
    for i in range(s.depth):
        b = f"blocks.{i}."
        out.update({b + "norm1.weight": (D,), b + "norm1.bias": (D,),
                    b + "attn.qkv.weight": (3 * D, D),
                    b + "attn.proj.weight": (D, D), b + "attn.proj.bias": (D,),
                    b + "ls1.gamma": (D,),
                    b + "norm2.weight": (D,), b + "norm2.bias": (D,),
                    b + "mlp.w1.weight": (H, D), b + "mlp.w1.bias": (H,),
                    b + "mlp.w2.weight": (H, D), b + "mlp.w2.bias": (H,),
                    b + "mlp.w3.weight": (D, H), b + "mlp.w3.bias": (D,),
                    b + "ls2.gamma": (D,)})
    out["norm.weight"] = (D,)
    out["norm.bias"] = (D,)
    return out


def periods(s: DinoV3Shape) -> torch.Tensor:
    n = s.dim // s.heads // 4
    return torch.tensor([s.rope_base ** (j / n) for j in range(n)], dtype=torch.float32)


def seeded_weights(s: DinoV3Shape, seed: int, device) -> dict:
    """Weights of the given shape from ``seed``, made on ``device`` in two
    large draws: one normal draw for every parameter but LayerScale and the
    periods (matrices at std 1 / sqrt(fan in) truncated at 2 std, biases at
    std 0.02, LayerNorm scales 1 + 0.1 N(0, 1), CLS, storage and mask tokens
    at std 0.02 truncated at 2 std), then the LayerScale vectors uniform in
    ``LAYERSCALE_RANGE``; the periods are the published ones. In f32."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    shapes = param_shapes(s)
    normal = {k: v for k, v in shapes.items()
              if not k.endswith("gamma") and k != "rope_embed.periods"}
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
    out["rope_embed.periods"] = periods(s).to(device)
    return {k: out[k] for k in shapes}


def rope_tables(per: torch.Tensor, gh: int, gw: int):
    """cos, sin [gh * gw, 4 len(per)] of the grid, patches in raster order."""
    rows, cols = [], []
    for r in range(gh):
        for c in range(gw):
            rows.append(2.0 * (r + 0.5) / gh - 1.0)
            cols.append(2.0 * (c + 0.5) / gw - 1.0)
    y = torch.tensor(rows, dtype=torch.float32, device=per.device)[:, None]
    x = torch.tensor(cols, dtype=torch.float32, device=per.device)[:, None]
    ang = torch.cat([2 * math.pi * y / per[None, :], 2 * math.pi * x / per[None, :]], dim=1)
    ang = torch.cat([ang, ang], dim=1)
    return torch.cos(ang), torch.sin(ang)


def rope(u: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """u [..., T, Dh] with tables [T, Dh]: u cos + rot(u) sin."""
    half = u.shape[-1] // 2
    return u * cos + torch.cat([-u[..., half:], u[..., :half]], dim=-1) * sin


def layer_norm(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps=LN_EPS)


def embed(p: dict, x: torch.Tensor, s: DinoV3Shape) -> tuple:
    """x [B, H, W, 3] f32 -> (tokens [B, 1 + R + N, D], the grid)."""
    t = F.conv2d(x.permute(0, 3, 1, 2), p["patch_embed.proj.weight"],
                 p["patch_embed.proj.bias"], stride=s.patch)
    gh, gw = t.shape[-2:]
    t = t.flatten(2).transpose(1, 2)
    B = t.shape[0]
    cls = p["cls_token"].expand(B, 1, s.dim)
    reg = p["storage_tokens"].expand(B, s.registers, s.dim)
    return torch.cat([cls, reg, t], dim=1), (gh, gw)


def _rotate(u, cos, sin, prefix: int, fault=None):
    if fault == "no_rope":
        return u
    if fault == "rope_on_prefix":
        n = cos.shape[0]
        return torch.cat([rope(u[:, :, :n], cos, sin), u[:, :, n:]], dim=2)
    return torch.cat([u[:, :, :prefix], rope(u[:, :, prefix:], cos, sin)], dim=2)


def block(p: dict, x: torch.Tensor, i: int, s: DinoV3Shape, tables, quant=None,
          fault=None, head_group: int = 8) -> torch.Tensor:
    k = f"blocks.{i}."
    B, T, D = x.shape
    Dh = D // s.heads
    prefix = 1 + s.registers
    ls = fault != "no_layerscale"
    ls1 = p[k + "ls1.gamma"] if ls else 1.0
    ls2 = p[k + "ls2.gamma"] if ls else 1.0
    h = layer_norm(x, p[k + "norm1.weight"], p[k + "norm1.bias"])
    qkv = linear(h, p[k + "attn.qkv.weight"], None, quant)
    qkv = qkv.reshape(B, T, 3, s.heads, Dh).permute(2, 0, 3, 1, 4)
    q = _rotate(qkv[0], *tables, prefix, fault)
    kk = _rotate(qkv[1], *tables, prefix, fault)
    v = qkv[2]
    o = torch.empty_like(q)
    for h0 in range(0, s.heads, head_group):
        hs = slice(h0, h0 + head_group)
        qh, kh = _mm_operands(q[:, hs], kk[:, hs], quant)
        att = torch.softmax((qh * Dh ** -0.5) @ kh.transpose(-2, -1), dim=-1)
        att, vh = _mm_operands(att, v[:, hs], quant)
        o[:, hs] = att @ vh
    o = o.transpose(1, 2).reshape(B, T, D)
    x = x + ls1 * linear(o, p[k + "attn.proj.weight"], p[k + "attn.proj.bias"], quant)
    h = layer_norm(x, p[k + "norm2.weight"], p[k + "norm2.bias"])
    a = linear(h, p[k + "mlp.w1.weight"], p[k + "mlp.w1.bias"], quant)
    g = linear(h, p[k + "mlp.w2.weight"], p[k + "mlp.w2.bias"], quant)
    return x + ls2 * linear(F.silu(a) * g, p[k + "mlp.w3.weight"], p[k + "mlp.w3.bias"], quant)


def tokens(p: dict, x: torch.Tensor, s: DinoV3Shape, quant=None, fault=None) -> torch.Tensor:
    """Every final-norm token [B, 1 + R + N, D] of images x [B, H, W, 3]."""
    t, (gh, gw) = embed(p, x, s)
    tables = rope_tables(p["rope_embed.periods"], gh, gw)
    for i in range(s.depth):
        t = block(p, t, i, s, tables, quant, fault)
    return layer_norm(t, p["norm.weight"], p["norm.bias"])


def features(p: dict, x: torch.Tensor, s: DinoV3Shape, quant=None, fault=None) -> torch.Tensor:
    """The dense features [B, N, D]: the final-norm patch tokens."""
    return tokens(p, x, s, quant, fault)[:, 1 + s.registers:]


@torch.no_grad()
def features_u8(p: dict, frames_u8: torch.Tensor, s: DinoV3Shape, size: int, mean, std,
                quant=None, fault=None, chunk: int = 2) -> torch.Tensor:
    """The patch features [N, P, D] of uint8 frames [N, H, W, 3] through the
    eval preprocess (``dense.preprocess``), ``chunk`` frames at a time, with
    TF32 off for matrix products and convolutions."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = [features(p, preprocess(frames_u8[i:i + chunk], size, mean, std), s, quant, fault)
               for i in range(0, frames_u8.shape[0], chunk)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return torch.cat(out)
