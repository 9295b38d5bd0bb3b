"""Multi-head self-attention: the plain version and the dispatcher.

Counterpart of ``timetuning_tpu/ops/attention.py``. ``attention_xla`` is the
plain version, the path of every block asked for its probabilities and of
f32 blocks up to 1024 tokens. ``attention`` routes as the JAX dispatcher
(:156-200) does on its TPU with ``impl="auto"``, by ``attention_route``:

  =====================  ===========  ========================
  tokens, dtype          probs        route
  =====================  ===========  ========================
  S > 1024               no           flash kernel
  S <= 1024, bf16        no           kernel 10 (not ported)
  S <= 1024, f32         no           plain
  any                    yes          plain
  =====================  ===========  ========================

A CPU tensor takes the plain version on every row, as JAX off the TPU
(:187). Kernel 10, the whole-sequence ``_mha_kernel`` (:53), is still to
port; a CUDA tensor that the table sends to it raises. The model never
sends one: a bf16 ViT block runs its own kernels unless it is asked for the
probabilities (models/vit.py).
"""

from __future__ import annotations

import math

import torch

# Above this many tokens (the CLS token counted) attention runs the flash
# kernel and a bf16 ViT block the row kernels (timetuning_tpu/ops/attention.py:192,
# models/vit.py:248-251): the TPU's whole-sequence kernels stop there.
WHOLE_SEQUENCE_TOKENS = 1024


def attention_xla(q, k, v, return_probs: bool = False):
    """q, k, v: [B, H, S, Dh]. Returns ([B, H, S, Dh], probs or None); the
    products accumulate in f32 and the probabilities are f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhqk,bhkd->bhqd", probs.to(v.dtype).float(), v.float()).to(q.dtype)
    return out, (probs if return_probs else None)


def attention_route(dtype: torch.dtype, seq_len: int, return_probs: bool,
                    on_cuda: bool) -> str:
    """"flash", "mha" (kernel 10) or "plain", by the table of the module
    docstring."""
    if not on_cuda or return_probs:
        return "plain"
    if seq_len > WHOLE_SEQUENCE_TOKENS:
        return "flash"
    return "mha" if dtype == torch.bfloat16 else "plain"


def attention(q, k, v, return_probs: bool = False):
    """q, k, v: [B, H, S, Dh] -> ([B, H, S, Dh], probs or None), routed by
    ``attention_route``."""
    route = attention_route(q.dtype, q.shape[2], return_probs,
                            q.device.type == "cuda")
    if route == "flash":
        from timetuning_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v), None
    if route == "mha":
        raise NotImplementedError(
            f"attention: {q.dtype} at {q.shape[2]} tokens routes to the "
            "whole-sequence kernel (timetuning_tpu/ops/attention.py:53 "
            "_mha_kernel), not ported yet (ROADMAP queue 2, row 10)")
    return attention_xla(q, k, v, return_probs=return_probs)
