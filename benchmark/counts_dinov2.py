"""Operations and bytes of DINOv2's blocks (SwiGLU MLP, LayerScale,
registers) at a cell's shapes, and the least times of the kernels that are
DINOv2's own, on the peaks of ``counts``. A multiply-add counts two
operations; each input is read once and each output written once; the
LayerScale products and the softmax are left out, as ``counts`` leaves out
the GELU's."""

from __future__ import annotations

from benchmark.counts import MEM_BYTES_PER_S, least_s, patch_embed_flops


def tokens(size: int, patch: int, registers: int) -> int:
    """CLS, the registers and the patches of one image."""
    return (size // patch) ** 2 + 1 + registers


def block_flops(tokens: int, dim: int, hidden: int) -> float:
    """One block on one image: qkv, attention (scores and values over all
    heads), proj, w12 (to 2 hidden) and w3."""
    return (2 * tokens * dim * (3 * dim + dim + 2 * hidden + hidden)
            + 4 * tokens * tokens * dim)


def block_bytes(images: int, tokens: int, dim: int, hidden: int, act_bytes: int = 2) -> float:
    """One block over ``images`` images: its input and output activations
    and its weights, once each, in the compute type."""
    weights = (3 * dim * dim + dim * dim + 3 * dim * hidden) * act_bytes
    return 2 * images * tokens * dim * act_bytes + weights


def blocks_least_s(images: int, tokens: int, dim: int, hidden: int, n_blocks: int) -> float:
    """The least time of ``n_blocks`` blocks over ``images`` images, a block
    at a time, in bf16."""
    return n_blocks * least_s(images * block_flops(tokens, dim, hidden),
                              block_bytes(images, tokens, dim, hidden))


def vit_flops(size: int, patch: int, dim: int, depth: int, hidden: int,
              registers: int) -> float:
    """The forward of one image: the patch embedding and every block."""
    return (patch_embed_flops(size, patch, dim)
            + depth * block_flops(tokens(size, patch, registers), dim, hidden))


def swiglu_least_s(rows: int, dim: int, hidden: int) -> float:
    """The tile's SwiGLU form once: ``rows`` normalised bf16 rows of ``dim``
    times ``w12`` [2 hidden, dim] with its f32 bias, to the bf16 hidden
    [rows, hidden]."""
    flops = 2 * rows * dim * 2 * hidden
    nbytes = 2 * (rows * dim + 2 * hidden * dim + rows * hidden) + 4 * 2 * hidden
    return least_s(flops, nbytes)


def ln_wide_least_s(rows: int, dim: int) -> float:
    """The LayerNorm pass once: ``rows`` bf16 rows of ``dim`` in and out, its
    f32 scale and bias; bound by its bytes."""
    return (2 * 2 * rows * dim + 2 * 4 * dim) / MEM_BYTES_PER_S
