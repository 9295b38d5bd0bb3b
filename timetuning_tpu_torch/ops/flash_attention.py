"""Exact attention for long sequences: the flash kernel and its plain version.

Counterpart of ``timetuning_tpu/ops/flash_attention.py``. One CUDA kernel
(csrc/flash_attention.cu) replaces both of its TPU kernels, the K/V-resident
``_flash_kernel`` (:47) and the K/V-streamed ``_flash_kernel_stream``
(:154): a Hopper SM's shared memory holds a few key tiles, not a head's
whole K/V, so the kernel always streams them. Heads of 64 or 32, in bf16 or
f32; heads of 128 (DINOv3 ViT-7B) in bf16 only, a form of their own
(``flash_bf16_d128_kernel``, counted as ``flash_d128``): an f32 input at 128
raises. Its backward is JAX's (``_chunked_bwd``, :274-327), plain torch:
``flash_attention_bwd``, the analytic softmax-attention gradient streamed
over query chunks.

Layout is JAX's, q ``[B, H, Sq, Dh]`` and k, v ``[B, H, Sk, Dh]``, and the
kernel reads strided views in place (the q, k, v slices of a qkv projection
need no copy); its output is a ``[B, H, Sq, Dh]`` view of a ``[B, Sq, H,
Dh]`` buffer, so merging the heads afterwards is free.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from timetuning_tpu_torch.ops import kernel_lib
from timetuning_tpu_torch.ops.attention import _aligned, _heads_fake, _heads_view, attention_xla

_NEG = -1e30

# the head widths the kernel takes, in bf16 and f32, and in bf16 only; any
# other raises
FLASH_HEAD_DIMS = (32, 64)
FLASH_BF16_HEAD_DIMS = (32, 64, 128)


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


def flash_attention_bwd(q, k, v, g, kv_len: int | None = None,
                        block_q: int = 256):
    """The gradient of ``flash_attention`` in q, k and v, as JAX's
    ``_chunked_bwd`` (``timetuning_tpu/ops/flash_attention.py:274-327``):
    the analytic softmax-attention gradient in f32, over query chunks of
    ``block_q`` (the queries padded with zero rows, whose terms are zeros),
    keys at or beyond ``kv_len`` at -1e30, dk and dv summed over the chunks,
    so the peak is O(block_q * Sk) a head and never O(Sq * Sk)."""
    B, H, S, Dh = q.shape
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(Dh)
    Sqp = -(-S // block_q) * block_q
    qf = F.pad(q.float(), (0, 0, 0, Sqp - S))
    gf = F.pad(g.float(), (0, 0, 0, Sqp - S))
    kf, vf = k.float(), v.float()
    key_ok = (None if kv_len is None or kv_len == Sk
              else torch.arange(Sk, device=q.device) < kv_len)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for c in range(0, Sqp, block_q):
        q_c, g_c = qf[:, :, c:c + block_q], gf[:, :, c:c + block_q]
        s = torch.einsum("bhqd,bhkd->bhqk", q_c, kf) * scale
        if key_ok is not None:
            s = torch.where(key_ok, s, torch.tensor(_NEG, dtype=s.dtype,
                                                     device=s.device))
        p = torch.softmax(s, dim=-1)
        dv += torch.einsum("bhqk,bhqd->bhkd", p, g_c)
        dp = torch.einsum("bhqd,bhkd->bhqk", g_c, vf)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq[:, :, c:c + block_q] = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, q_c) * scale
    return dq[:, :, :S].to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashVJP(torch.autograd.Function):
    """The flash kernel forward, ``flash_attention_bwd`` backward (JAX's
    ``_flash_core`` custom VJP, :329-341)."""

    @staticmethod
    def forward(ctx, kernel, q, k, v, kv_len):
        ctx.kv_len = kv_len
        ctx.save_for_backward(q, k, v)
        return kernel(q, k, v, kv_len)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (None, *flash_attention_bwd(q, k, v, g, ctx.kv_len), None)


@kernel_lib.kernel_entry(
    "flash_attention", "(Tensor q, Tensor k, Tensor v, int? kv_len=None) -> Tensor",
    lambda q, k, v, kv_len=None: _heads_fake(q), lambda kernel, *a: _FlashVJP.apply(kernel, *a))
def flash_attention(q, k, v, kv_len: int | None = None):
    """Kernels 5 and 6 (csrc/flash_attention.cu). q [B, H, Sq, Dh], k and v
    [B, H, Sk, Dh], Dh 32 or 64, bf16 or f32, or 128 in bf16 (launches
    counted as ``flash_d128``); ``kv_len`` masks keys at or
    beyond it. Returns [B, H, Sq, Dh] in q's dtype, a view of a [B, Sq, H,
    Dh] buffer (on CPU tensors too: the custom op's fake has one layout)."""
    if q.device.type == "cpu":
        return _heads_view(flash_attention_xla(q, k, v, kv_len))
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: expected q [B, H, Sq, Dh] and k, v "
                         f"[B, H, Sk, Dh], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, Dh = q.shape
    Sk = k.shape[2]
    if k.shape[:2] != (B, H) or k.shape[3] != Dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch, heads or width")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: expected q, k, v all bf16 or all "
                         f"f32, got {q.dtype}, {k.dtype}, {v.dtype}")
    dims = FLASH_BF16_HEAD_DIMS if q.dtype == torch.bfloat16 else FLASH_HEAD_DIMS
    if Dh not in dims:
        raise ValueError(f"flash_attention: the kernel takes 32- or 64-wide heads, and "
                         f"128-wide in bf16; got Dh={Dh} in {q.dtype}")
    valid = Sk if kv_len is None else int(kv_len)
    if not 1 <= valid <= Sk:
        raise ValueError(f"flash_attention: kv_len={kv_len} outside [1, {Sk}]")
    kernel_lib.require_cuda("flash_attention", q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((B, Sq, H, Dh), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    kernel_lib.launch(
        "flash_d128" if Dh == 128 else "flash_attention", "tt_flash_attention", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), B, H, Sq, Sk, valid, Dh,
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    return out
