"""Torch reference ViT for the checkpoint-import parity gate.

Copied from ``timetuning_tpu/eval/parity_oracle.py`` (which imports no JAX;
the port imports nothing of that package, so it keeps this copy, pinned to
the original by ``tests/test_torch_host_copies.py``). The published
``TimeT.pth`` contract (reference README.md:66-76): stripping the first two
dot components of each key yields a timm ``vit_small_patch16_224`` state
dict. The parity harness (cli/parity) holds the port's ViT loaded from that
file against this textbook pre-norm ViT with the exact timm key layout (the
same compute graph as reference dino_vision_transformer.py:108-273, written
from the definition), built from the same state dict: an oracle independent
of the code under test.
"""

from __future__ import annotations

import math


def _torch():
    import torch

    return torch


def build_oracle(img_size: int, patch_size: int, dim: int, depth: int, heads: int):
    """Construct the torch oracle (random weights, timm key names)."""
    torch = _torch()
    nn = torch.nn

    class OracleBlock(nn.Module):
        def __init__(self, dim, heads, mlp_ratio=4.0):
            super().__init__()
            self.norm1 = nn.LayerNorm(dim, eps=1e-6)
            self.norm2 = nn.LayerNorm(dim, eps=1e-6)
            self.heads = heads
            self.attn = nn.ModuleDict(
                {"qkv": nn.Linear(dim, dim * 3), "proj": nn.Linear(dim, dim)}
            )
            h = int(dim * mlp_ratio)
            self.mlp = nn.ModuleDict(
                {"fc1": nn.Linear(dim, h), "fc2": nn.Linear(h, dim)}
            )

        def attend(self, x, return_probs=False):
            B, S, D = x.shape
            H = self.heads
            qkv = (
                self.attn["qkv"](x)
                .reshape(B, S, 3, H, D // H)
                .permute(2, 0, 3, 1, 4)
            )
            q, k, v = qkv[0], qkv[1], qkv[2]
            scores = q @ k.transpose(-2, -1) / math.sqrt(D // H)
            probs = scores.softmax(dim=-1)
            out = (probs @ v).transpose(1, 2).reshape(B, S, D)
            return self.attn["proj"](out), (probs if return_probs else None)

        def forward(self, x, return_probs=False):
            y, probs = self.attend(self.norm1(x), return_probs)
            x = x + y
            y = self.norm2(x)
            y = self.mlp["fc2"](torch.nn.functional.gelu(self.mlp["fc1"](y)))
            return x + y, probs

    class OracleViT(nn.Module):
        def __init__(self):
            super().__init__()
            self.patch_size = patch_size
            n = (img_size // patch_size) ** 2
            self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
            self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, dim))
            self.patch_embed = nn.ModuleDict(
                {"proj": nn.Conv2d(3, dim, patch_size, stride=patch_size)}
            )
            self.blocks = nn.ModuleList(
                OracleBlock(dim, heads) for _ in range(depth)
            )
            self.norm = nn.LayerNorm(dim, eps=1e-6)
            with torch.no_grad():
                for p in self.parameters():
                    p.normal_(0, 0.02)

        def interp_pos(self, hp, wp):
            n = self.pos_embed.shape[1] - 1
            n0 = int(round(n ** 0.5))
            if (hp, wp) == (n0, n0):
                return self.pos_embed
            cls_pos = self.pos_embed[:, :1]
            grid = self.pos_embed[:, 1:].reshape(1, n0, n0, -1).permute(0, 3, 1, 2)
            # DINO's exact call (dino_vision_transformer.py:226-231): the
            # +0.1 fudged SCALE FACTOR, which torch uses directly in the
            # coordinate mapping — size-based interpolation differs by up
            # to ~0.2 on small grids
            grid = torch.nn.functional.interpolate(
                grid,
                scale_factor=((hp + 0.1) / n0, (wp + 0.1) / n0),
                mode="bicubic",
            )
            assert grid.shape[-2:] == (hp, wp)
            grid = grid.permute(0, 2, 3, 1).reshape(1, hp * wp, -1)
            return torch.cat([cls_pos, grid], dim=1)

        def embed(self, x):
            """Patch-embedding tokens only (the BASELINE.md patch-embed gate)."""
            B = x.shape[0]
            x = self.patch_embed["proj"](x)
            return x.flatten(2).transpose(1, 2)

        def forward(self, x, return_probs=False):
            # x: [B, 3, H, W]
            B = x.shape[0]
            x = self.patch_embed["proj"](x)
            hp, wp = x.shape[-2:]
            x = x.flatten(2).transpose(1, 2)
            x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)
            x = x + self.interp_pos(hp, wp)
            probs = None
            for i, blk in enumerate(self.blocks):
                x, p = blk(x, return_probs and i == len(self.blocks) - 1)
                if p is not None:
                    probs = p
            return self.norm(x), probs

    return OracleViT()


def build_oracle_head(dims, in_dim):
    """The reference projection head: nn.Sequential of Linear/GELU
    (models.py:914-926) — Sequential indices 0,2,4,... are the Linears."""
    torch = _torch()
    nn = torch.nn
    layers = []
    prev = in_dim
    for i, d in enumerate(dims):
        layers.append(nn.Linear(prev, d))
        if i != len(dims) - 1:
            layers.append(nn.GELU())
        prev = d
    return nn.Sequential(*layers)


def oracle_from_state_dict(sd, img_size: int, num_heads: int):
    """Build the torch oracle sized from a (prefix-stripped, backbone-only)
    timm-layout state dict and load it. Returns the eval-mode module."""
    torch = _torch()
    w = sd["patch_embed.proj.weight"]
    dim, _, ph, _ = w.shape
    import re

    depth = 1 + max(
        int(m.group(1)) for k in sd if (m := re.match(r"blocks\.(\d+)\.", k))
    )
    oracle = build_oracle(img_size, int(ph), int(dim), depth, num_heads)
    tensors = {k: torch.as_tensor(v) for k, v in sd.items()}
    oracle.load_state_dict(tensors)
    return oracle.eval()
