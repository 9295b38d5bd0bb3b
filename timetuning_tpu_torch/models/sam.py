"""The image encoder of Segment Anything (SAM), ViT-H, in PyTorch.

Kirillov et al. 2023, arXiv:2304.02643; ``facebookresearch/segment-anything``
``segment_anything/build_sam.py`` (``build_sam_vit_h``) and
``modeling/image_encoder.py``. The port's own, with no JAX counterpart: the
encoder that SAM-based video object segmentation (Track Anything, SAM-Track,
SAM-PT) runs on every frame.

* A 16 x 16 patch convolution to D; no CLS token; a learned ``pos_embed``
  [1, G, G, D] (G = 64 at the published 1,024 input) added as it is: SAM
  never resizes it, so another input size raises.
* Pre-norm blocks (LayerNorm eps 1e-6, qkv with a bias, an exact-GELU MLP
  ``mlp.lin1`` / ``mlp.lin2``). The blocks of ``global_blocks`` attend over
  the whole grid; the others within ``window`` x ``window`` windows of LN1's
  output padded with zero rows at the bottom and right (SAM masks no key:
  the padded positions take part), merged back and cropped before the
  residual.
* Every block's scores carry the decomposed relative-position bias, ``q .
  Rh[qh - kh + K - 1] + q . Rw[qw - kw + K - 1]`` with the unscaled q, from
  ``attn.rel_pos_h`` / ``rel_pos_w`` [2 K - 1, Dh] (K the window's side or
  the grid's).
* The neck: a 1 x 1 convolution to 256 without bias, LayerNorm2d, a 3 x 3
  convolution (padding 1, no bias), LayerNorm2d, both eps 1e-6.

``forward(x [B, H, W, 3])`` returns the ViT's dict: ``tokens`` [B, G * G,
256] (the image embedding's tokens in raster order), ``attention`` None,
``intermediates`` [tokens], ``grid`` (G, G). Parameter names are the
release checkpoint's with its ``image_encoder.`` prefix taken off.

Routing: a bf16 block runs the hand-written kernels (``fused_block.
attention_block_branch_relpos``: LN1 + qkv in window order, the heads-of-80
core with the bias, proj + residual over the grid's rows; ``mlp_rows``,
the GELU MLP at D 1,280); on CPU tensors their plain versions. An f32
encoder runs the plain composition (the core's plain version,
``flash_attention.relpos_attention_xla``) on the CPU only: the card's core
at heads of 80 is bf16 only, so an f32 block on the card raises. The neck
runs PyTorch's convolutions in the compute dtype and LayerNorm2d in f32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from timetuning_tpu_torch.models.vit import PatchEmbed, _linear
from timetuning_tpu_torch.ops.flash_attention import relpos_attention_xla, window_rows
from timetuning_tpu_torch.ops.fused_block import (
    _LN_EPS,
    _ln,
    attention_block_branch_relpos,
    mlp_rows,
)


@dataclasses.dataclass(frozen=True)
class SamConfig:
    patch_size: int = 16
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    img_size: int = 1024
    window_size: int = 14
    global_blocks: tuple = (7, 15, 23, 31)
    out_chans: int = 256
    dtype: torch.dtype = torch.float32   # compute dtype; params stay f32

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


def sam_vit_h(**kw) -> SamConfig:
    """SAM ViT-H (``build_sam_vit_h``: D 1,280, 32 blocks, 16 heads of 80,
    MLP 5,120, window 14, global blocks 7, 15, 23 and 31, input 1,024)."""
    return SamConfig(**kw)


class SamAttention(nn.Module):
    """The block's attention parameters: ``qkv``, ``proj`` and the
    relative-position tables [2 K - 1, Dh] of its side K."""

    def __init__(self, dim: int, num_heads: int, side: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * side - 1, dim // num_heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * side - 1, dim // num_heads))


class SamMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return _linear(F.gelu(_linear(x, self.lin1), approximate="none"), self.lin2)


class SamBlock(nn.Module):
    """One encoder block; ``window`` 0: global."""

    def __init__(self, c: SamConfig, window: int):
        super().__init__()
        self.num_heads = c.num_heads
        self.dtype = c.dtype
        self.grid = c.grid
        self.window = window
        self.norm1 = nn.LayerNorm(c.embed_dim, eps=_LN_EPS)
        self.attn = SamAttention(c.embed_dim, c.num_heads, window or c.grid)
        self.norm2 = nn.LayerNorm(c.embed_dim, eps=_LN_EPS)
        self.mlp = SamMlp(c.embed_dim, int(c.embed_dim * c.mlp_ratio))

    def forward(self, x):
        """x [B, G * G, D] in the grid's raster order."""
        G, win, a = self.grid, self.window, self.attn
        if x.is_cuda and self.dtype != torch.bfloat16:
            raise ValueError(f"SamBlock: the card's attention core at heads of 80 is bf16 "
                             f"only, got a {self.dtype} encoder; an f32 SAM runs on the CPU")
        if self.dtype == torch.bfloat16:
            m, dt = self.mlp, self.dtype
            x = attention_block_branch_relpos(
                x.to(dt), self.norm1.weight, self.norm1.bias, a.qkv.weight.t().to(dt),
                a.qkv.bias, a.proj.weight.t().to(dt), a.proj.bias, a.rel_pos_h.to(dt),
                a.rel_pos_w.to(dt), self.num_heads, G, win)
            return mlp_rows(x, self.norm2.weight, self.norm2.bias, m.lin1.weight.t().to(dt),
                            m.lin1.bias, m.lin2.weight.t().to(dt), m.lin2.bias)
        h = _ln(x, self.norm1.weight, self.norm1.bias)
        qkv = _linear(window_rows(h, G, win) if win else h, a.qkv)
        o = relpos_attention_xla(qkv, a.rel_pos_h, a.rel_pos_w, self.num_heads, G, win)
        x = x + _linear(o, a.proj)
        return x + self.mlp(_ln(x, self.norm2.weight, self.norm2.bias))


class LayerNorm2d(nn.Module):
    """SAM's ``LayerNorm2d``: over the channels of [B, C, H, W], in f32."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        f = x.float()
        u = f.mean(1, keepdim=True)
        v = (f - u).pow(2).mean(1, keepdim=True)
        f = (f - u) * torch.rsqrt(v + _LN_EPS)
        return (self.weight[:, None, None] * f + self.bias[:, None, None]).to(x.dtype)


class SamImageEncoder(nn.Module):
    """SAM's ``ImageEncoderViT``. ``forward(x)`` with x [B, H, W, 3] (NHWC)."""

    def __init__(self, config: SamConfig):
        super().__init__()
        c = config
        self.config = c
        self.patch_embed = PatchEmbed(c.patch_size, c.embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, c.grid, c.grid, c.embed_dim))
        self.blocks = nn.ModuleList(
            SamBlock(c, 0 if i in c.global_blocks else c.window_size) for i in range(c.depth))
        self.neck = nn.Sequential(
            nn.Conv2d(c.embed_dim, c.out_chans, 1, bias=False), LayerNorm2d(c.out_chans),
            nn.Conv2d(c.out_chans, c.out_chans, 3, padding=1, bias=False),
            LayerNorm2d(c.out_chans))

    def init_weights(self, generator: torch.Generator) -> "SamImageEncoder":
        """Seeded random init in the release's layout: LeCun normal
        (truncated at two deviations) convolution and dense weights, biases
        and the relative-position tables normal with std 0.02, ``pos_embed``
        truncated normal with std 0.02, unit LayerNorm scales and zero
        shifts."""
        with torch.no_grad():
            nn.init.trunc_normal_(self.pos_embed, std=0.02, generator=generator)
            for mod in self.modules():
                if isinstance(mod, (nn.Linear, nn.Conv2d)):
                    std = mod.weight[0].numel() ** -0.5
                    nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                                          generator=generator)
                    if mod.bias is not None:
                        nn.init.normal_(mod.bias, std=0.02, generator=generator)
                elif isinstance(mod, (nn.LayerNorm, LayerNorm2d)):
                    nn.init.ones_(mod.weight)
                    nn.init.zeros_(mod.bias)
                elif isinstance(mod, SamAttention):
                    nn.init.normal_(mod.rel_pos_h, std=0.02, generator=generator)
                    nn.init.normal_(mod.rel_pos_w, std=0.02, generator=generator)
        return self

    def forward(self, x: torch.Tensor, want_attention: bool = False):
        c = self.config
        if want_attention:
            raise ValueError("SamImageEncoder: no attention probabilities (the blocks attend "
                             "within windows)")
        if tuple(x.shape[1:3]) != (c.img_size, c.img_size):
            raise ValueError(f"SamImageEncoder: the encoder takes {c.img_size} x {c.img_size} "
                             f"images (SAM never resizes pos_embed), got {tuple(x.shape[1:3])}")
        dt = c.dtype
        pe = self.patch_embed.proj
        x = F.conv2d(x.permute(0, 3, 1, 2).to(dt), pe.weight.to(dt), pe.bias.to(dt),
                     stride=c.patch_size)
        B, D, G, _ = x.shape
        x = (x.permute(0, 2, 3, 1) + self.pos_embed.to(dt)).reshape(B, G * G, D)
        for block in self.blocks:
            x = block(x)
        n = self.neck
        y = x.reshape(B, G, G, D).permute(0, 3, 1, 2)
        y = n[1](F.conv2d(y, n[0].weight.to(dt)))
        y = n[3](F.conv2d(y, n[2].weight.to(dt), padding=1))
        tokens = y.flatten(2).transpose(1, 2)
        return {"tokens": tokens, "attention": None, "intermediates": [tokens],
                "grid": (G, G)}


def sam_state_dict(sd: dict) -> dict:
    """A release checkpoint's image encoder: the ``image_encoder.`` keys
    with the prefix taken off (the prompt encoder and the mask decoder left
    out); a file without such keys is taken as the encoder's own."""
    pre = "image_encoder."
    if any(k.startswith(pre) for k in sd):
        return {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    return dict(sd)
