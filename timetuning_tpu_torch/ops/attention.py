"""Multi-head self-attention: the plain version, the whole-sequence kernel
and the dispatcher.

Counterpart of ``timetuning_tpu/ops/attention.py``. ``attention_xla`` is the
plain version, the path of every block asked for its probabilities and of
f32 blocks up to 1024 tokens. ``attention_mha`` is kernel 10
(csrc/mha.cu), the whole-sequence kernel of up to 1024 tokens, forward only
(``mha_plan`` says how it walks a sequence of S tokens);
``_AttentionFused`` gives it the JAX package's custom VJP (the forward is
the kernel, the backward the analytic softmax-attention gradient recomputed
in plain torch: the JAX package has no backward kernel either).

``attention`` routes as the JAX dispatcher (:156-200), by ``impl``:

  ``xla``      the plain version, always;
  ``pallas``   the kernels, always (``fused`` means the same): the flash
               kernel above 1024 tokens, kernel 10 up to 1024, in bf16 or
               f32; asking for the probabilities raises;
  ``auto``     by ``attention_route``:

  =====================  ===========  ========================
  tokens, dtype          probs        route
  =====================  ===========  ========================
  S > 1024               no           flash kernel
  S <= 1024, bf16        no           kernel 10
  S <= 1024, f32         no           plain
  any                    yes          plain
  =====================  ===========  ========================

A CPU tensor takes the plain version on every ``auto`` row, as JAX off the
TPU (:187), and a kernel wrapper given a CPU tensor runs its plain version.
"""

from __future__ import annotations

import math

import torch

from timetuning_tpu_torch.ops import kernel_lib

# Above this many tokens (the CLS token counted) attention runs the flash
# kernel and a bf16 ViT block the row kernels (timetuning_tpu/ops/attention.py:192,
# models/vit.py:248-251): the TPU's whole-sequence kernels stop there.
WHOLE_SEQUENCE_TOKENS = 1024

IMPLS = ("auto", "xla", "pallas", "fused")


def attention_xla(q, k, v, return_probs: bool = False):
    """q, k, v: [B, H, S, Dh]. Returns ([B, H, S, Dh], probs or None); the
    products accumulate in f32 and the probabilities are f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhqk,bhkd->bhqd", probs.to(v.dtype).float(), v.float()).to(q.dtype)
    return out, (probs if return_probs else None)


def attention_mha_plain(q, k, v):
    """The plain version of kernel 10: ``attention_xla``'s arithmetic, which
    is ``_mha_kernel``'s (``timetuning_tpu/ops/attention.py:53-76``): scaled
    f32 scores, the softmax normalised before the second product, the
    probabilities rounded to v's dtype, the product with v accumulated in
    f32, the output in q's dtype. The TPU kernel's key mask only hides its
    own padding of S; nothing is padded here."""
    return attention_xla(q, k, v)[0]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernel can read it in place (head features contiguous,
    16-byte aligned rows), else a contiguous copy."""
    per16 = 16 // t.element_size()
    if (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % per16 == 0 for s in t.stride()[:3])):
        return t
    return t.contiguous()


# The key counts that the one-pass bf16 kernel can hold as one strip of
# scores in a warpgroup's registers (the widths of its wgmma instruction),
# and the key chunk of the two-pass kernel.
ONE_PASS_KEYS = (64, 128, 208, 256)
TWO_PASS_CHUNK = 128


def mha_plan(seq_len: int) -> tuple[int, int]:
    """How kernel 10 walks ``seq_len`` tokens: ``(passes, keys)``. Up to 256
    tokens, one pass: in bf16 the head's whole K and V in shared memory and
    each 64-row strip of scores in registers, padded to ``keys``, the
    narrowest of ``ONE_PASS_KEYS`` that holds the sequence (208 at 197
    tokens); in f32 the strip of scores in shared memory. Up to 1024 tokens,
    two passes (row statistics, then p @ v; in bf16 over K resident in
    shared memory in chunks of ``TWO_PASS_CHUNK`` keys), ``keys`` the
    sequence rounded up to whole chunks. f32 reads only ``passes``.
    csrc/mha.cu checks the plan it is handed."""
    if not 1 <= seq_len <= WHOLE_SEQUENCE_TOKENS:
        raise ValueError(f"attention_mha: the kernel takes at least one and at "
                         f"most {WHOLE_SEQUENCE_TOKENS} tokens, got S={seq_len} "
                         "(the flash kernel serves longer sequences)")
    if seq_len <= ONE_PASS_KEYS[-1]:
        return 1, next(n for n in ONE_PASS_KEYS if n >= seq_len)
    return 2, -(-seq_len // TWO_PASS_CHUNK) * TWO_PASS_CHUNK


def attention_mha(q, k, v):
    """Kernel 10 (csrc/mha.cu). q, k, v: [B, H, S, 64] with S <= 1024, all
    bf16 or all f32, read as the strided views they are. Returns
    [B, H, S, 64] in q's dtype, a view of a [B, S, H, 64] buffer, so merging
    the heads afterwards is free. Forward only: ``attention(...,
    impl="pallas")`` wraps it with its backward."""
    kernel_lib.require_no_grad("attention_mha", q, k, v)
    if q.device.type == "cpu":
        return attention_mha_plain(q, k, v)
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"attention_mha: expected q, k, v of one shape "
                         f"[B, H, S, Dh], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, Dh = q.shape
    if Dh != 64:
        raise ValueError(f"attention_mha: the kernel takes 64-wide heads, got "
                         f"Dh={Dh}")
    passes, keys = mha_plan(S)
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError(f"attention_mha: expected q, k, v all bf16 or all "
                         f"f32, got {q.dtype}, {k.dtype}, {v.dtype}")
    kernel_lib.require_cuda("attention_mha", q, k, v)
    q, k, v = _aligned(q.detach()), _aligned(k.detach()), _aligned(v.detach())
    out = torch.empty((B, S, H, Dh), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    kernel_lib.launch(
        "mha", "tt_mha", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), B, H, S, passes, keys,
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    return out


class _AttentionFused(torch.autograd.Function):
    """Kernel 10 with the backward of ``_attention_fused_bwd``
    (``timetuning_tpu/ops/attention.py:134-150``): the probabilities are
    recomputed in f32 from q and k (memory-cheap at these sequence lengths)
    and the four gradient products are plain torch."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return attention_mha(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        scale = 1.0 / math.sqrt(q.shape[-1])
        qf, kf, vf, g32 = q.float(), k.float(), v.float(), g.float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
        p = torch.softmax(s, dim=-1)
        dv = torch.einsum("bhqk,bhqd->bhkd", p, g32)
        dp = torch.einsum("bhqd,bhkd->bhqk", g32, vf)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
        dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_route(dtype: torch.dtype, seq_len: int, return_probs: bool,
                    on_cuda: bool, impl: str = "auto") -> str:
    """"flash", "mha" (kernel 10) or "plain", by the module docstring."""
    if impl not in IMPLS:
        raise ValueError(f"attention: unknown impl {impl!r}; one of {IMPLS}")
    if impl in ("pallas", "fused"):
        if return_probs:
            raise RuntimeError(
                "attention probabilities are only available through the "
                "plain path (the whole-sequence and flash kernels never "
                "materialise them); with a forced kernel impl, request them "
                "via impl='xla' or 'auto': mask_features needs the last "
                "block's probabilities, so it cannot be combined with "
                "attn_impl='pallas' or 'fused'")
        return "flash" if seq_len > WHOLE_SEQUENCE_TOKENS else "mha"
    if impl == "xla" or not on_cuda or return_probs:
        return "plain"
    if seq_len > WHOLE_SEQUENCE_TOKENS:
        return "flash"
    return "mha" if dtype == torch.bfloat16 else "plain"


def attention(q, k, v, return_probs: bool = False, impl: str = "auto"):
    """q, k, v: [B, H, S, Dh] -> ([B, H, S, Dh], probs or None), routed by
    ``attention_route``. The kernel-10 route is differentiable
    (``_AttentionFused``); the flash route is forward only."""
    route = attention_route(q.dtype, q.shape[2], return_probs,
                            q.device.type == "cuda", impl)
    if route == "flash":
        from timetuning_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v), None
    if route == "mha":
        return _AttentionFused.apply(q, k, v), None
    return attention_xla(q, k, v, return_probs=return_probs)
