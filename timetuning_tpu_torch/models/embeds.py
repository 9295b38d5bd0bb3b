# The port's own copy of timetuning_tpu/models/embeds.py (host code, no JAX);
# tests/test_torch_host_copies.py pins it to the original.
"""Fixed 2-D sin-cos positional embeddings (MAE/MoCo-v3 style).

Reference: models.py:1328-1375 (``get_2d_sincos_pos_embed`` family).
"""

from __future__ import annotations

import numpy as np


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed_from_grid(embed_dim: int, grid: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def get_2d_sincos_pos_embed(
    embed_dim: int, grid_size: int, cls_token: bool = False
) -> np.ndarray:
    grid_h = np.arange(grid_size, dtype=np.float64)
    grid_w = np.arange(grid_size, dtype=np.float64)
    grid = np.meshgrid(grid_w, grid_h)          # w goes first (MAE convention)
    grid = np.stack([grid[0], grid[1]], axis=0).reshape(2, 1, grid_size, grid_size)
    pos = get_2d_sincos_pos_embed_from_grid(embed_dim, grid)
    if cls_token:
        pos = np.concatenate([np.zeros((1, embed_dim)), pos], axis=0)
    return pos.astype(np.float32)
