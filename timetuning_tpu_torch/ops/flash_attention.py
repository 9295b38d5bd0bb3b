"""Exact attention for long sequences: the flash kernel and its plain version.

Counterpart of ``timetuning_tpu/ops/flash_attention.py``. One CUDA kernel
(csrc/flash_attention.cu) replaces both of its TPU kernels, the K/V-resident
``_flash_kernel`` (:47) and the K/V-streamed ``_flash_kernel_stream``
(:154): a Hopper SM's shared memory holds a few key tiles, not a head's
whole K/V, so the kernel always streams them. The forward only: the port
runs no backward through it.

Layout is JAX's, q ``[B, H, Sq, Dh]`` and k, v ``[B, H, Sk, Dh]``, and the
kernel reads strided views in place (the q, k, v slices of a qkv projection
need no copy); its output is a ``[B, H, Sq, Dh]`` view of a ``[B, Sq, H,
Dh]`` buffer, so merging the heads afterwards is free.
"""

from __future__ import annotations

import math

import torch

from timetuning_tpu_torch.ops import kernel_lib
from timetuning_tpu_torch.ops.attention import attention_xla

_NEG = -1e30


def flash_attention_xla(q, k, v, kv_len: int | None = None):
    """The plain version (``timetuning_tpu/ops/flash_attention.py:258-271``):
    scores in f32, keys at or beyond ``kv_len`` set to -1e30, softmax, the
    probabilities rounded to v's dtype before the f32 product with v."""
    if kv_len is None or kv_len == k.shape[2]:
        return attention_xla(q, k, v)[0]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    col = torch.arange(k.shape[2], device=q.device)
    s = torch.where(col[None, None, None, :] < kv_len, s,
                    torch.tensor(_NEG, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernel can read it in place (head features contiguous,
    16-byte aligned rows), else a contiguous copy."""
    per16 = 16 // t.element_size()
    if (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % per16 == 0 for s in t.stride()[:3])):
        return t
    return t.contiguous()


def flash_attention(q, k, v, kv_len: int | None = None):
    """Kernels 5 and 6 (csrc/flash_attention.cu). q [B, H, Sq, 64], k and v
    [B, H, Sk, 64], bf16 or f32; ``kv_len`` masks keys at or beyond it.
    Returns [B, H, Sq, 64] in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_xla(q, k, v, kv_len)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: expected q [B, H, Sq, Dh] and k, v "
                         f"[B, H, Sk, Dh], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, Dh = q.shape
    Sk = k.shape[2]
    if k.shape[:2] != (B, H) or k.shape[3] != Dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch, heads or width")
    if Dh != 64:
        raise ValueError(f"flash_attention: the kernel takes 64-wide heads, "
                         f"got Dh={Dh}")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: expected q, k, v all bf16 or all "
                         f"f32, got {q.dtype}, {k.dtype}, {v.dtype}")
    valid = Sk if kv_len is None else int(kv_len)
    if not 1 <= valid <= Sk:
        raise ValueError(f"flash_attention: kv_len={kv_len} outside [1, {Sk}]")
    kernel_lib.require_cuda("flash_attention", q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((B, Sq, H, Dh), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    kernel_lib.launch(
        "flash_attention", "tt_flash_attention", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), B, H, Sq, Sk, valid,
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    return out
