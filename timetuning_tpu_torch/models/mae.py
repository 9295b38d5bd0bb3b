"""The masked-autoencoder ViT (encoder and decoder), on PyTorch.

Counterpart of ``timetuning_tpu/models/mae.py`` (reference
models.py:1378-1600, ``MaskedAutoencoderViT`` and mae_vit_base / large /
huge). The zoo runs the encoder with mask ratio 0 (``forward_encoder(x, 0)``,
models.py:989-993) as a frozen dense feature extractor; the decoder and the
random masking are here for the pre-training objective. Its blocks are the
plain composition (``attn_impl="xla"``), as the JAX package builds them
(:47-62): MAE launches no kernel, in either dtype. The sin-cos position
tables are rebuilt for the grid of each input (``models/embeds``), so the
encoder runs at any resolution. Parameter names follow the MAE release.
Input NHWC.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from timetuning_tpu_torch.models.embeds import get_2d_sincos_pos_embed
from timetuning_tpu_torch.models.vit import Block, PatchEmbed, _linear
from timetuning_tpu_torch.ops.fused_block import _ln


class MAEViT(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 decoder_embed_dim: int = 512, decoder_depth: int = 8,
                 decoder_num_heads: int = 16, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size, self.embed_dim, self.dtype = patch_size, embed_dim, dtype
        self.decoder_embed_dim = decoder_embed_dim
        self.grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, True, dtype, "xla")
            for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self.decoder_embed = nn.Linear(embed_dim, decoder_embed_dim)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_embed_dim))
        self.decoder_blocks = nn.ModuleList(
            Block(decoder_embed_dim, decoder_num_heads, mlp_ratio, True, dtype, "xla")
            for _ in range(decoder_depth))
        self.decoder_norm = nn.LayerNorm(decoder_embed_dim, eps=1e-6)
        self.decoder_pred = nn.Linear(decoder_embed_dim, patch_size ** 2 * 3)

    def _pos(self, dim: int, grid: int, like: torch.Tensor) -> torch.Tensor:
        """The sin-cos table [1, 1 + grid^2, dim] (CLS row first) for the
        runtime grid: a function of position only, so rebuilding it is the
        exact analogue of interpolating a learned table."""
        return torch.from_numpy(get_2d_sincos_pos_embed(dim, grid, cls_token=True))[
            None].to(like.device)

    def random_masking(self, x, mask_ratio: float, noise=None, generator=None):
        """Keep the ``N (1 - mask_ratio)`` tokens of lowest ``noise`` [B, N]
        (uniform, drawn from ``generator`` when not given). -> (kept tokens,
        mask [B, N] with 1 at the removed ones, ids_restore)."""
        B, N, D = x.shape
        len_keep = int(N * (1 - mask_ratio))
        if noise is None:
            noise = torch.rand((B, N), generator=generator)
        noise = noise.to(x.device)
        ids_shuffle = torch.argsort(noise, dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        ids_keep = ids_shuffle[:, :len_keep]
        x_masked = torch.gather(x, 1, ids_keep[..., None].expand(-1, -1, D))
        mask = torch.ones(B, N, device=x.device)
        mask[:, :len_keep] = 0
        return x_masked, torch.gather(mask, 1, ids_restore), ids_restore

    def forward_encoder(self, x, mask_ratio: float = 0.0, noise=None, generator=None):
        B, H = x.shape[:2]
        grid = H // self.patch_size
        pe = self.patch_embed.proj
        dt = self.dtype
        t = F.conv2d(x.permute(0, 3, 1, 2).to(dt), pe.weight.to(dt), pe.bias.to(dt),
                     stride=self.patch_size)
        t = t.flatten(2).transpose(1, 2)
        pos = self._pos(self.embed_dim, grid, t)
        t = t + pos[:, 1:].to(t.dtype)
        if mask_ratio > 0:
            t, mask, ids_restore = self.random_masking(t, mask_ratio, noise, generator)
        else:
            mask = ids_restore = None
        cls = (self.cls_token + pos[:, :1]).expand(B, 1, self.embed_dim)
        t = torch.cat([cls.to(t.dtype), t], dim=1)
        for blk in self.blocks:
            t, _ = blk(t)
        return _ln(t, self.norm.weight, self.norm.bias), mask, ids_restore

    def forward_decoder(self, x, ids_restore):
        B = x.shape[0]
        x = _linear(x, self.decoder_embed)
        N = ids_restore.shape[1]
        n_masked = N + 1 - x.shape[1]
        mask_tokens = self.mask_token.expand(B, n_masked, self.decoder_embed_dim)
        x_ = torch.cat([x[:, 1:], mask_tokens.to(x.dtype)], dim=1)
        x_ = torch.gather(x_, 1, ids_restore[..., None].expand(-1, -1, x.shape[-1]))
        x = torch.cat([x[:, :1], x_], dim=1)
        g = int(round(N ** 0.5))
        x = x + self._pos(self.decoder_embed_dim, g, x).to(x.dtype)
        for blk in self.decoder_blocks:
            x, _ = blk(x)
        x = _ln(x, self.decoder_norm.weight, self.decoder_norm.bias)
        return _linear(x, self.decoder_pred)[:, 1:]

    def patchify(self, imgs):
        p = self.patch_size
        B, H, W, C = imgs.shape
        h, w = H // p, W // p
        x = imgs.reshape(B, h, p, w, p, C)
        return torch.einsum("bhpwqc->bhwpqc", x).reshape(B, h * w, p * p * C)

    def reconstruction_loss(self, imgs, pred, mask, norm_pix_loss: bool = True):
        target = self.patchify(imgs)
        if norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, unbiased=False)
            target = (target - mean) / torch.sqrt(var + 1e-6)
        loss = ((pred - target) ** 2).mean(dim=-1)
        return (loss * mask).sum() / mask.sum().clamp(min=1.0)

    def pretrain(self, x, mask_ratio: float = 0.75, noise=None, generator=None,
                 norm_pix_loss: bool = True):
        """The whole MAE objective: mask, encode, decode, pixel loss
        (reference ``forward``, models.py:1560-1570)."""
        tokens, mask, ids_restore = self.forward_encoder(x, mask_ratio, noise, generator)
        pred = self.forward_decoder(tokens, ids_restore)
        return self.reconstruction_loss(x, pred, mask, norm_pix_loss), pred, mask

    def forward(self, x, want_attention: bool = False, mask_ratio: float = 0.0,
                noise=None, generator=None):
        """The zoo's contract: the normed tokens, CLS first."""
        del want_attention
        tokens, _, _ = self.forward_encoder(x, mask_ratio, noise, generator)
        g = x.shape[1] // self.patch_size
        return {"tokens": tokens, "attention": None, "intermediates": [tokens],
                "grid": (g, g)}


def mae_vit_base(**kw) -> MAEViT:
    return MAEViT(embed_dim=768, depth=12, num_heads=12, **kw)


def mae_vit_large(**kw) -> MAEViT:
    return MAEViT(embed_dim=1024, depth=24, num_heads=16, **kw)


def mae_vit_huge(**kw) -> MAEViT:
    return MAEViT(embed_dim=1280, depth=32, num_heads=16, patch_size=14, **kw)
