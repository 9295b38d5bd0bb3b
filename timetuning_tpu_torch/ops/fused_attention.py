"""Plain composition of the ViT attention residual branch.

Counterpart of ``timetuning_tpu/ops/fused_attention.py``:
``attention_branch_xla`` computes ``proj(attention(qkv(x_ln)))`` from the
post-LayerNorm tokens. It is the plain version that the attention-block
kernel (ops/fused_block.attention_block_branch) is held against.
"""

from __future__ import annotations

import math

import torch


def attention_branch_xla(x_ln, w_qkv, b_qkv, w_proj, b_proj, num_heads: int):
    """x_ln: [B, S, D] (post-LayerNorm); weights in [in, out] layout.
    Returns [B, S, D] in ``x_ln``'s dtype. Products accumulate in f32; qkv,
    the probabilities and the per-head output round to ``x_ln``'s dtype at
    the same points as the JAX composition."""
    B, S, D = x_ln.shape
    Dh = D // num_heads
    qkv = torch.matmul(x_ln.float(), w_qkv.float())
    if b_qkv is not None:
        qkv = qkv + b_qkv
    qkv = qkv.to(x_ln.dtype).reshape(B, S, 3, num_heads, Dh)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(Dh))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    o = o.to(x_ln.dtype).permute(0, 2, 1, 3).reshape(B, S, D)
    out = torch.matmul(o.float(), w_proj.float()) + b_proj
    return out.to(x_ln.dtype)
