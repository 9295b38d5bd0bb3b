"""Generic transformer encoder/decoder and Gumbel sampling, in PyTorch.

Counterpart of ``timetuning_tpu/models/generic_transformer.py`` (reference
transformer.py, which nothing imports: kept for inventory parity): Gumbel
max / softmax sampling, multi-head attention with an optional mask, a
learned positional encoding, post-norm encoder and causally masked decoder
stacks. The sub-module names are the JAX modules' (``pos.embedding``,
``layer{i}``, ``attn`` / ``self_attn`` / ``cross_attn`` with ``wq``, ``wk``,
``wv``, ``wo``, ``norm1..3``, ``fc1``, ``fc2``); LayerNorm eps is Flax's
1e-6. Random draws: JAX's key has no torch twin, so the Gumbel helpers draw
their uniforms from a ``torch.Generator`` or take them as ``u`` (the tests
hand them JAX's, from the same key).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

_LN_EPS = 1e-6       # Flax's LayerNorm default


def _uniform(shape, generator, u, device=None):
    if u is not None:
        return torch.as_tensor(np.asarray(u, np.float32).copy(), device=device)
    return torch.rand(shape, generator=generator, device=device)


def sample_gumbel(shape, generator: torch.Generator | None = None, eps: float = 1e-20,
                  u=None, device=None):
    """-log(-log(u + eps) + eps), u uniform in [0, 1)."""
    u = _uniform(shape, generator, u, device)
    return -torch.log(-torch.log(u + eps) + eps)


def gumbel_softmax(logits, temperature: float = 1.0, hard: bool = False,
                   generator: torch.Generator | None = None, u=None):
    """softmax((logits + Gumbel noise) / temperature); ``hard``: the one-hot
    argmax forward with the soft sample's gradient (straight through)."""
    g = sample_gumbel(logits.shape, generator, u=u, device=logits.device)
    y = torch.softmax((logits + g) / temperature, dim=-1)
    if hard:
        y_hard = F.one_hot(y.argmax(dim=-1), logits.shape[-1]).to(y.dtype)
        y = (y_hard - y).detach() + y
    return y


def gumbel_max(logits, generator: torch.Generator | None = None, u=None):
    """argmax(logits + Gumbel noise): a sample of softmax(logits)."""
    g = sample_gumbel(logits.shape, generator, u=u, device=logits.device)
    return (logits + g).argmax(dim=-1)


def _dense(lin: nn.Linear, x, dtype):
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


class LearnedPositionalEncoding(nn.Module):
    def __init__(self, dim: int, max_len: int = 512):
        super().__init__()
        self.embedding = nn.Parameter(torch.randn(max_len, dim) * 0.02)

    def forward(self, x):
        return x + self.embedding[: x.shape[1]][None]


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.wq, self.wk, self.wv, self.wo = (nn.Linear(dim, dim) for _ in range(4))

    def forward(self, q, k, v, mask=None):
        """q [B, Sq, D], k and v [B, Sk, D]; ``mask`` broadcast to [B, H, Sq,
        Sk], True where attention is allowed. Returns (out, probabilities)."""
        D = q.shape[-1]
        H = self.num_heads
        Dh = D // H

        def split(x, lin):
            return _dense(lin, x, self.dtype).reshape(
                x.shape[0], x.shape[1], H, Dh).permute(0, 2, 1, 3)

        qh, kh, vh = split(q, self.wq), split(k, self.wk), split(v, self.wv)
        scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / torch.tensor(
            math.sqrt(Dh), dtype=qh.dtype)
        if mask is not None:
            scores = torch.where(mask, scores, torch.tensor(-1e30, dtype=scores.dtype))
        attn = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, vh)
        out = out.permute(0, 2, 1, 3).reshape(q.shape[0], q.shape[1], D)
        return _dense(self.wo, out, self.dtype), attn


class EncoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.attn = MultiHeadAttention(dim, num_heads, dtype)
        self.norm1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=_LN_EPS)

    def forward(self, x, mask=None):
        y, _ = self.attn(x, x, x, mask)
        x = self.norm1(x + y)
        y = _dense(self.fc2, F.relu(_dense(self.fc1, x, self.dtype)), self.dtype)
        return self.norm2(x + y)


class TransformerEncoder(nn.Module):
    def __init__(self, dim: int, depth: int = 6, num_heads: int = 8,
                 mlp_dim: int = 2048, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
        self.pos = LearnedPositionalEncoding(dim)
        for i in range(depth):
            self.add_module(f"layer{i}", EncoderLayer(dim, num_heads, mlp_dim, dtype))

    def forward(self, x, mask=None):
        x = self.pos(x)
        for i in range(self.depth):
            x = getattr(self, f"layer{i}")(x, mask)
        return x


class DecoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MultiHeadAttention(dim, num_heads, dtype)
        self.norm1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.cross_attn = MultiHeadAttention(dim, num_heads, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)
        self.norm3 = nn.LayerNorm(dim, eps=_LN_EPS)

    def forward(self, x, memory, self_mask=None, cross_mask=None):
        y, _ = self.self_attn(x, x, x, self_mask)
        x = self.norm1(x + y)
        y, _ = self.cross_attn(x, memory, memory, cross_mask)
        x = self.norm2(x + y)
        y = _dense(self.fc2, F.relu(_dense(self.fc1, x, self.dtype)), self.dtype)
        return self.norm3(x + y)


class TransformerDecoder(nn.Module):
    def __init__(self, dim: int, depth: int = 6, num_heads: int = 8,
                 mlp_dim: int = 2048, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
        self.pos = LearnedPositionalEncoding(dim)
        for i in range(depth):
            self.add_module(f"layer{i}", DecoderLayer(dim, num_heads, mlp_dim, dtype))

    def forward(self, x, memory):
        S = x.shape[1]
        causal = torch.tril(torch.ones(S, S, dtype=torch.bool, device=x.device))[None, None]
        x = self.pos(x)
        for i in range(self.depth):
            x = getattr(self, f"layer{i}")(x, memory, causal)
        return x
