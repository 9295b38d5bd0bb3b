"""Operations and bytes of the work a cell asks for, computed from its
shapes, and the published peaks of one NVIDIA H100 SXM.

A multiply-add counts two operations. The least time of a piece of work is
the larger of its operations over the peak of their type and its bytes
(each input read once, each output written once) over the memory rate.
What the program happens to recompute or re-read is not counted.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense, at its 700 W limit
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
MEM_BYTES_PER_S = 3.35e12


def least_s(flops: float, nbytes: float, kind: str = "bf16") -> float:
    return max(flops / PEAK_FLOPS[kind], nbytes / MEM_BYTES_PER_S)


def block_flops(tokens: int, dim: int, hidden: int) -> float:
    """One pre-norm ViT block on one image of ``tokens`` tokens: the qkv,
    attention (scores and values over all heads), output and MLP
    products."""
    return 2 * tokens * dim * (3 * dim + dim + 2 * hidden) + 4 * tokens * tokens * dim


def block_bytes(images: int, tokens: int, dim: int, hidden: int, act_bytes: int = 2) -> float:
    """One block over ``images`` images: its input and output activations
    and its weights, once each, in the compute type."""
    weights = (3 * dim * dim + dim * dim + 2 * dim * hidden) * act_bytes
    return 2 * images * tokens * dim * act_bytes + weights


def blocks_least_s(images: int, tokens: int, dim: int, hidden: int, n_blocks: int) -> float:
    """The least time of ``n_blocks`` blocks over ``images`` images, a
    block at a time, in bf16."""
    return n_blocks * least_s(images * block_flops(tokens, dim, hidden),
                              block_bytes(images, tokens, dim, hidden))


def patch_embed_flops(size: int, patch: int, dim: int) -> float:
    return 2 * (size // patch) ** 2 * 3 * patch * patch * dim


def vit_flops(size: int, patch: int, dim: int, depth: int, hidden: int) -> float:
    """The forward of one image: the patch embedding and every block."""
    tokens = (size // patch) ** 2 + 1
    return patch_embed_flops(size, patch, dim) + depth * block_flops(tokens, dim, hidden)


def head_flops(patches: int, dims: tuple) -> float:
    return 2 * patches * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def propagation_flops(B: int, T: int, N: int, D: int, K: int, n_last: int, radius: int,
                      topk: int) -> float:
    """Label propagation of B clips of T frames (N patches, D channels, K
    labels): the affinities of every target patch with the keys in its
    window in each context frame (frame 0 and up to ``n_last`` earlier
    ones), and its top-k entries times the K labels."""
    w = int(round(N ** 0.5))
    r = radius if radius > 0 else w
    per_axis = sum(min(i + r, w - 1) - max(i - r, 0) + 1 for i in range(w))
    n_slots = max(min(n_last, T - 2), 1)
    contexts = sum(1 + min(t - 1, n_slots) for t in range(1, T))
    return B * (contexts * per_axis ** 2 * 2 * D + (T - 1) * N * topk * K * 2)


def train_step_flops(B: int, T: int, size: int, patch: int, dim: int, depth: int,
                     hidden: int, head_dims: tuple, n_trained: int, K: int,
                     n_last: int, radius: int, topk: int) -> float:
    """The model operations a TimeT step requires for B clips of T frames:
    the ViT over every frame (the propagation's features), the teacher's
    trained blocks and head on the first frame, the student's head on the
    last frame and the backward of the student's trained blocks and head
    (twice their forward: the gradients of the inputs and of the weights),
    the prototype scores of both, the propagation. The student's forward of
    its trained blocks on the last frame repeats the first pass and is not
    counted."""
    tokens = (size // patch) ** 2 + 1
    N = tokens - 1
    hd = (dim, *head_dims)
    frame = vit_flops(size, patch, dim, depth, hidden)
    tail = n_trained * block_flops(tokens, dim, hidden)
    head = head_flops(N, hd)
    scores = 2 * N * head_dims[-1] * K
    per_clip = (T * frame + (tail + head + scores)          # teacher, first frame
                + (head + scores)                            # student forward
                + 2 * (tail + head + scores))                # student backward
    return B * per_clip + propagation_flops(B, T, N, dim, K, n_last, radius, topk)
