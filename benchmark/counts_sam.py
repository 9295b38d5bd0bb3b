"""Operations and bytes of SAM ViT-H's image encoder at a cell's shapes, and
the least times of the kernels that are its own, on the peaks of ``counts``.

The model's operations are counted as SAM's forward computes them: a
windowed block's qkv, attention and proj run over its windows' rows, the
grid padded to a multiple of the window (4,900 rows a frame at 1,024 for a
grid of 4,096), so the padded rows' products are counted; the attention's
bias tables are SAM's two products ``q . Rh`` and ``q . Rw`` over the
gathered [K, K, Dh] tables; the softmax is left out, as ``counts`` leaves
out the GELU's. The least times count the work the result needs: qkv,
the queries of attention, proj and the MLP over the grid's rows only (a
padded row's q, k and v are the qkv bias, with no product, and what a
padded query or a padded row's proj would give is cropped), each query
against the whole window's keys, the padded positions among them (SAM masks
none); inputs read once, outputs written once, in bf16. The GELU MLP's
products are ``counts_dinov2``'s shapes with one hidden (lin1 to
``hidden``, lin2 back)."""

from __future__ import annotations

from benchmark.counts import MEM_BYTES_PER_S, least_s, patch_embed_flops


def grid(size: int, patch: int) -> int:
    return size // patch


def window_rows(g: int, window: int) -> int:
    """The rows of a frame's windows: the grid padded to a multiple of the
    window."""
    n = -(-g // window) * window
    return n * n


def attn_flops(queries: int, S: int, K: int, dim: int) -> float:
    """Attention of ``queries`` query rows, each against a sequence of S =
    K * K keys, every head: the scores and the values (4 S dim a query) and
    the two bias products (4 K dim a query)."""
    return queries * (4 * S * dim + 4 * K * dim)


def block_flops(g: int, window: int, dim: int, hidden: int, least: bool = False) -> float:
    """One block on one frame of a g x g grid (``window`` 0: global): qkv,
    the queries of attention and proj over the windows' rows (as SAM's
    forward; ``least``: over the grid's rows only), the MLP over the grid's
    rows."""
    n = g * g
    K = window or g
    rows = n if least or not window else window_rows(g, window)
    return (2 * rows * dim * 3 * dim + attn_flops(rows, K * K, K, dim)
            + 2 * rows * dim * dim + 4 * n * dim * hidden)


def neck_flops(g: int, dim: int, out: int) -> float:
    return 2 * g * g * (dim * out + out * out * 9)


def model_flops(size: int, patch: int, dim: int, hidden: int, depth: int, window: int,
                global_blocks, out: int) -> float:
    """The forward of one frame as SAM computes it: the patch embedding,
    every block (the windows' padded rows included), the neck."""
    g = grid(size, patch)
    blocks = sum(block_flops(g, 0 if i in global_blocks else window, dim, hidden)
                 for i in range(depth))
    return patch_embed_flops(size, patch, dim) + blocks + neck_flops(g, dim, out)


def block_bytes(frames: int, g: int, window: int, dim: int, hidden: int) -> float:
    """One block over ``frames`` frames: the grid's input and output rows
    and its weights (the bias tables among them), once each, in bf16."""
    K = window or g
    weights = 3 * dim * dim + dim * dim + 2 * dim * hidden + 2 * (2 * K - 1) * (dim // 16)
    return 2 * (2 * frames * g * g * dim + weights)


def blocks_least_s(frames: int, size: int, patch: int, dim: int, hidden: int, depth: int,
                   window: int, global_blocks) -> float:
    """The least time of every block over ``frames`` frames, a block at a
    time, in bf16: the work the result needs (qkv, the queries and proj over
    the grid's rows)."""
    g = grid(size, patch)
    total = 0.0
    for i in range(depth):
        w = 0 if i in global_blocks else window
        total += least_s(frames * block_flops(g, w, dim, hidden, least=True),
                         block_bytes(frames, g, w, dim, hidden))
    return total


def attn_least_s(frames: int, size: int, patch: int, dim: int, depth: int, window: int,
                 global_blocks) -> float:
    """The heads-of-80 core with the bias in every block over ``frames``
    frames: the grid's queries only (a padded query's output is cropped),
    each against its window's keys, the padded ones among them; q of the
    grid's rows, k and v of the windows' rows read and the grid's output
    rows written once in bf16 (the bias tables' f32 round trip is the
    program's choice, not counted)."""
    g = grid(size, patch)
    total = 0.0
    for i in range(depth):
        K = g if i in global_blocks else window
        kv_rows = g * g if i in global_blocks else window_rows(g, window)
        total += least_s(frames * attn_flops(g * g, K * K, K, dim),
                         frames * 2 * (2 * g * g * dim + 2 * kv_rows * dim))
    return total


def gelu_mlp_least_s(rows: int, dim: int, hidden: int) -> float:
    """The GELU MLP at D ``dim`` once over ``rows`` rows, as its three
    launches: the LayerNorm pass (bytes: the rows in and out, its scale and
    shift), lin1 + GELU (the normed rows, lin1 and the bf16 hidden) and
    lin2 + the residual (the hidden, lin2, the residual in and the output);
    each its own least, summed."""
    ln = (2 * 2 * rows * dim + 2 * 4 * dim) / MEM_BYTES_PER_S
    fc1 = least_s(2 * rows * dim * hidden, 2 * (rows * dim + hidden * dim + rows * hidden))
    fc2 = least_s(2 * rows * hidden * dim, 2 * (rows * hidden + dim * hidden + 2 * rows * dim))
    return ln + fc1 + fc2
