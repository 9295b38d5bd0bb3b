"""Operations and bytes of DINOv3 ViT-7B's blocks at a cell's shapes, and the
least times of the kernels that are its own, on the peaks of ``counts``.

Its block's products are DINOv2's (``counts_dinov2``: qkv, attention, proj,
two hidden-wide products and w3; w1 and w2 stacked are DINOv2's w12), and
so is its LayerNorm pass; what is its own: the RoPE tables, read once as
bytes (the rotation's arithmetic is left out, as the softmax's), and the
flash core at heads of 128."""

from __future__ import annotations

from benchmark.counts import least_s
from benchmark.counts_dinov2 import block_flops, tokens, vit_flops  # noqa: F401
from benchmark.counts_dinov2 import block_bytes as dinov2_block_bytes
from benchmark.counts_dinov2 import ln_wide_least_s as ln_least_s  # noqa: F401


def rope_bytes(patches: int, head_dim: int) -> float:
    """The RoPE tables once: cos and sin [patches, head_dim] in f32."""
    return 2 * 4 * patches * head_dim


def blocks_least_s(images: int, tokens: int, dim: int, hidden: int, n_blocks: int,
                   patches: int, head_dim: int) -> float:
    """The least time of ``n_blocks`` blocks over ``images`` images, a block
    at a time, in bf16: DINOv2's block and the RoPE tables."""
    nbytes = dinov2_block_bytes(images, tokens, dim, hidden) + rope_bytes(patches, head_dim)
    return n_blocks * least_s(images * block_flops(tokens, dim, hidden), nbytes)


def attn_least_s(images: int, tokens: int, dim: int) -> float:
    """The flash core once over ``images`` images (every head): the scores
    and the values, 4 T^2 D operations an image, against q, k and v read and
    the output written once in bf16."""
    return least_s(images * 4 * tokens * tokens * dim, images * 4 * tokens * dim * 2)


def qkv_rope_least_s(rows: int, dim: int, patches: int, head_dim: int) -> float:
    """The qkv product with the RoPE epilogue once: ``rows`` normalised bf16
    rows of ``dim`` times ``w`` [3 dim, dim] (no bias), to the bf16 [rows, 3
    dim], and the RoPE tables once."""
    flops = 2 * rows * dim * 3 * dim
    nbytes = 2 * (rows * dim + 3 * dim * dim + rows * 3 * dim) + rope_bytes(patches, head_dim)
    return least_s(flops, nbytes)
