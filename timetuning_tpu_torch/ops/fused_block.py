"""The two residual branches of a ViT block, as hand-written CUDA kernels.

Up to 1024 tokens, one kernel a branch:

  * ``attention_block_branch``:  x + proj(attention(qkv(LN1(x))))
  * ``mlp_block_branch``:        x + fc2(gelu(fc1(LN2(x))))

Above 1024 tokens (``timetuning_tpu/ops/fused_block.py:270-449``), the row
kernels and the flash core:

  * ``attention_block_branch_flash``: ``ln_dense_rows`` (LN1 + qkv) ->
    ``ops/flash_attention`` -> ``dense_residual_rows`` (proj + residual);
  * ``mlp_rows``: LN2 + MLP + residual over the token rows.

Counterpart of ``timetuning_tpu/ops/fused_block.py``. Weights keep the JAX
package's layout, ``[in, out]`` (pass ``linear.weight.t()``). For a bf16
CUDA tensor a wrapper launches its kernel (csrc/attention_block.cu,
csrc/mlp_block.cu, csrc/rows_block.cu); for a CPU tensor it runs the plain
composition beside it (``attention_block_xla``, ``mlp_block_xla``,
``ln_dense_xla``, ``dense_residual_xla``, named after their JAX
counterparts). Every product of the plain versions is taken in f32 from its
operands' values, as the JAX compositions' ``preferred_element_type=f32``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from timetuning_tpu_torch.ops import kernel_lib
from timetuning_tpu_torch.ops.flash_attention import flash_attention

_LN_EPS = 1e-6   # the reference LayerNorm eps (torch's default is 1e-5)


def _ln_rows(xf, scale, bias):
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + _LN_EPS) * scale + bias


def _ln(x, scale, bias):
    """LayerNorm computed in f32, returned in ``x``'s dtype."""
    return _ln_rows(x.float(), scale.float(), bias.float()).to(x.dtype)


def _dot(a, w):
    """``a @ w`` with f32 accumulation of the operands' values."""
    return torch.matmul(a.float(), w.float())


def attention_block_xla(x, ln_s, ln_b, w_qkv, b_qkv, w_proj, b_proj,
                        num_heads: int):
    from timetuning_tpu_torch.ops.fused_attention import attention_branch_xla

    return x + attention_branch_xla(
        _ln(x, ln_s, ln_b), w_qkv, b_qkv, w_proj, b_proj, num_heads)


def mlp_block_xla(x, ln_s, ln_b, w1, b1, w2, b2):
    h = _dot(_ln(x, ln_s, ln_b), w1) + b1
    h = F.gelu(h, approximate="none").to(x.dtype)
    out = _dot(h, w2) + b2
    return x + out.to(x.dtype)


def ln_dense_xla(x, ln_s, ln_b, w, b):
    return (_dot(_ln(x, ln_s, ln_b), w) + b).to(x.dtype)


def dense_residual_xla(y, x, w, b):
    """``x + (y @ w + b)``, the sum in f32 and rounded once
    (``timetuning_tpu/ops/fused_block.py:391-394``)."""
    return (x.float() + (_dot(y, w) + b)).to(x.dtype)


def _f32(t, n):
    return (torch.zeros(n, dtype=torch.float32, device=t.device) if t is None
            else t.detach().float().contiguous())


def _weight_nk(w):
    """[in, out] weight -> bf16 [out, in] contiguous (the kernels' layout).
    Free for the transposed view of a torch Linear weight."""
    return w.detach().to(torch.bfloat16).t().contiguous()


def _check_x(name, x):
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise ValueError(f"{name}: expected bf16 [B, S, D], got {x.dtype} "
                         f"{tuple(x.shape)}")


def _check_dense(name, D, w):
    """``w`` [D, E]: the GEMM tile takes D % 32 == 0 and E % 8 == 0."""
    if w.dim() != 2 or w.shape[0] != D or D % 32 or w.shape[1] % 8:
        raise ValueError(f"{name}: weight shape {tuple(w.shape)} for D={D} "
                         "(in width a multiple of 32, out width of 8)")


def attention_block_branch(x, ln_s, ln_b, w_qkv, b_qkv, w_proj, b_proj,
                           num_heads: int):
    """Kernel 1 (csrc/attention_block.cu). ``x``: [B, S, D] bf16."""
    kernel_lib.require_no_grad("attention_block_branch", x, ln_s, ln_b, w_qkv,
                               b_qkv, w_proj, b_proj)
    if x.device.type == "cpu":
        return attention_block_xla(x, ln_s, ln_b, w_qkv, b_qkv, w_proj, b_proj,
                                   num_heads)
    _check_x("attention_block_branch", x)
    B, S, D = x.shape
    if D % num_heads or D // num_heads != 64 or D % 32:
        raise ValueError(f"attention_block_branch: the kernel takes 64-wide "
                         f"heads, got D={D}, heads={num_heads}")
    if tuple(w_qkv.shape) != (D, 3 * D) or tuple(w_proj.shape) != (D, D):
        raise ValueError("attention_block_branch: weight shapes "
                         f"{tuple(w_qkv.shape)}, {tuple(w_proj.shape)} for D={D}")
    x = x.contiguous()
    args = [x, _f32(ln_s, D), _f32(ln_b, D), _weight_nk(w_qkv),
            _f32(b_qkv, 3 * D), _weight_nk(w_proj), _f32(b_proj, D)]
    kernel_lib.require_cuda("attention_block_branch", *args)
    qkv = torch.empty(B * S, 3 * D, dtype=torch.bfloat16, device=x.device)
    merged = torch.empty(B * S, D, dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    kernel_lib.launch(
        "attention_block", "tt_attention_block", x.device,
        *(a.data_ptr() for a in args), qkv.data_ptr(), merged.data_ptr(),
        out.data_ptr(), B, S, D, num_heads)
    return out


def _mlp_launch(kernel, x, ln_s, ln_b, w1, b1, w2, b2):
    """csrc/mlp_block.cu's two GEMMs over the B*S token rows, counted as
    ``kernel``."""
    _check_x(kernel, x)
    B, S, D = x.shape
    Hd = w1.shape[1]
    if (tuple(w1.shape) != (D, Hd) or tuple(w2.shape) != (Hd, D)
            or D % 32 or Hd % 32 or D > 1024):
        raise ValueError(f"{kernel}: weight shapes {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)} for D={D} (widths must be "
                         "multiples of 32, D <= 1024)")
    x = x.contiguous()
    args = [x, _f32(ln_s, D), _f32(ln_b, D), _weight_nk(w1), _f32(b1, Hd),
            _weight_nk(w2), _f32(b2, D)]
    kernel_lib.require_cuda(kernel, *args)
    hidden = torch.empty(B * S, Hd, dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    kernel_lib.launch(
        kernel, "tt_mlp_block", x.device,
        *(a.data_ptr() for a in args), hidden.data_ptr(), out.data_ptr(),
        B * S, D, Hd)
    return out


def mlp_block_branch(x, ln_s, ln_b, w1, b1, w2, b2):
    """Kernel 2 (csrc/mlp_block.cu). ``x``: [B, S, D] bf16."""
    kernel_lib.require_no_grad("mlp_block_branch", x, ln_s, ln_b, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return mlp_block_xla(x, ln_s, ln_b, w1, b1, w2, b2)
    return _mlp_launch("mlp_block", x, ln_s, ln_b, w1, b1, w2, b2)


def mlp_rows(x, ln_s, ln_b, w1, b1, w2, b2):
    """Kernel 9, the row-chunked LN2 + MLP + residual of sequences over 1024
    tokens (``_mlp_rows_pallas``, ``timetuning_tpu/ops/fused_block.py:350``).
    csrc/mlp_block.cu's GEMM tile is row-tiled already, so this launches it,
    counted as ``mlp_rows``. ``x``: [B, S, D] bf16."""
    kernel_lib.require_no_grad("mlp_rows", x, ln_s, ln_b, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return mlp_block_xla(x, ln_s, ln_b, w1, b1, w2, b2)
    return _mlp_launch("mlp_rows", x, ln_s, ln_b, w1, b1, w2, b2)


def ln_dense_rows(x, ln_s, ln_b, w, b):
    """Kernel 7 (csrc/rows_block.cu ``tt_ln_dense``): ``LN(x) @ w + b`` over
    the token rows (``_ln_dense_pallas``,
    ``timetuning_tpu/ops/fused_block.py:364``). ``x``: [B, S, D] bf16,
    ``w``: [D, E]."""
    kernel_lib.require_no_grad("ln_dense_rows", x, ln_s, ln_b, w, b)
    if x.device.type == "cpu":
        return ln_dense_xla(x, ln_s, ln_b, w, b)
    _check_x("ln_dense_rows", x)
    B, S, D = x.shape
    _check_dense("ln_dense_rows", D, w)
    if D > 1024:
        raise ValueError(f"ln_dense_rows: the LN prologue takes D <= 1024, got {D}")
    E = w.shape[1]
    x = x.contiguous()
    args = [x, _f32(ln_s, D), _f32(ln_b, D), _weight_nk(w), _f32(b, E)]
    kernel_lib.require_cuda("ln_dense_rows", *args)
    out = torch.empty(B, S, E, dtype=torch.bfloat16, device=x.device)
    kernel_lib.launch("ln_dense", "tt_ln_dense", x.device,
                      *(a.data_ptr() for a in args), out.data_ptr(), B * S, E, D)
    return out


def dense_residual_rows(y, x, w, b):
    """Kernel 8 (csrc/rows_block.cu ``tt_dense_residual``):
    ``x + (y @ w + b)``, the sum in f32, over the token rows
    (``_dense_residual_pallas``, ``timetuning_tpu/ops/fused_block.py:376``).
    ``y``: [B, S, K] bf16, ``x``: [B, S, E] bf16, ``w``: [K, E]."""
    kernel_lib.require_no_grad("dense_residual_rows", y, x, w, b)
    if y.device.type == "cpu":
        return dense_residual_xla(y, x, w, b)
    _check_x("dense_residual_rows", y)
    _check_x("dense_residual_rows", x)
    B, S, K = y.shape
    _check_dense("dense_residual_rows", K, w)
    E = w.shape[1]
    if tuple(x.shape) != (B, S, E):
        raise ValueError(f"dense_residual_rows: residual {tuple(x.shape)} for "
                         f"output [{B}, {S}, {E}]")
    args = [y.contiguous(), x.contiguous(), _weight_nk(w), _f32(b, E)]
    kernel_lib.require_cuda("dense_residual_rows", *args)
    out = torch.empty(B, S, E, dtype=torch.bfloat16, device=y.device)
    kernel_lib.launch("dense_residual", "tt_dense_residual", y.device,
                      *(a.data_ptr() for a in args), out.data_ptr(), B * S, E, K)
    return out


def attention_block_branch_flash(x, ln_s, ln_b, w_qkv, b_qkv, w_proj, b_proj,
                                 num_heads: int):
    """The attention branch of sequences over 1024 tokens
    (``timetuning_tpu/ops/fused_block.py:433-449``): ``ln_dense_rows`` ->
    the flash core (ops/flash_attention) -> ``dense_residual_rows``. The
    q, k, v heads are strided views of the qkv rows, and the flash output
    is already in the merged [B, S, D] layout: no copies between the three
    kernels. On CPU tensors, the composition of their plain versions."""
    B, S, D = x.shape
    qkv = ln_dense_rows(x, ln_s, ln_b, w_qkv, b_qkv)
    qkv = qkv.reshape(B, S, 3, num_heads, D // num_heads)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    merged = flash_attention(q, k, v).permute(0, 2, 1, 3).reshape(B, S, D)
    return dense_residual_rows(merged, x, w_proj, b_proj)
