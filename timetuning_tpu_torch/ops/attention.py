"""Multi-head self-attention that can return its probabilities.

Counterpart of ``attention_xla`` in ``timetuning_tpu/ops/attention.py``: the
path of the ``Attention`` module when the last block's probabilities are
wanted, and of every f32 block.
"""

from __future__ import annotations

import math

import torch


def attention_xla(q, k, v, return_probs: bool = False):
    """q, k, v: [B, H, S, Dh]. Returns ([B, H, S, Dh], probs or None); the
    products accumulate in f32 and the probabilities are f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhqk,bhkd->bhqd", probs.to(v.dtype).float(), v.float()).to(q.dtype)
    return out, (probs if return_probs else None)
