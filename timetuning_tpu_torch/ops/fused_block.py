"""The two residual branches of a ViT block, each a hand-written CUDA kernel.

  * ``attention_block_branch``:  x + proj(attention(qkv(LN1(x))))
  * ``mlp_block_branch``:        x + fc2(gelu(fc1(LN2(x))))

Counterpart of ``timetuning_tpu/ops/fused_block.py``. Weights keep the JAX
package's layout, ``[in, out]`` (pass ``linear.weight.t()``). For a bf16
CUDA tensor a wrapper launches its kernel (csrc/attention_block.cu,
csrc/mlp_block.cu); for a CPU tensor it runs the plain composition beside it
(``attention_block_xla`` / ``mlp_block_xla``, named after their JAX
counterparts). Every product of the plain versions is taken in f32 from its
operands' values, as the JAX compositions' ``preferred_element_type=f32``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from timetuning_tpu_torch.ops import kernel_lib

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
    if x.shape[1] > 1024:
        raise NotImplementedError(
            f"{name}: {x.shape[1]} tokens; sequences over 1024 need the "
            "long-token path (ROADMAP queue 1, long-token item)")


def attention_block_branch(x, ln_s, ln_b, w_qkv, b_qkv, w_proj, b_proj,
                           num_heads: int):
    """Kernel 1 (csrc/attention_block.cu). ``x``: [B, S, D] bf16."""
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


def mlp_block_branch(x, ln_s, ln_b, w1, b1, w2, b2):
    """Kernel 2 (csrc/mlp_block.cu). ``x``: [B, S, D] bf16."""
    if x.device.type == "cpu":
        return mlp_block_xla(x, ln_s, ln_b, w1, b1, w2, b2)
    _check_x("mlp_block_branch", x)
    B, S, D = x.shape
    Hd = w1.shape[1]
    if (tuple(w1.shape) != (D, Hd) or tuple(w2.shape) != (Hd, D)
            or D % 32 or Hd % 32):
        raise ValueError(f"mlp_block_branch: weight shapes {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)} for D={D} (widths must be "
                         "multiples of 32)")
    x = x.contiguous()
    args = [x, _f32(ln_s, D), _f32(ln_b, D), _weight_nk(w1), _f32(b1, Hd),
            _weight_nk(w2), _f32(b2, D)]
    kernel_lib.require_cuda("mlp_block_branch", *args)
    hidden = torch.empty(B * S, Hd, dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    kernel_lib.launch(
        "mlp_block", "tt_mlp_block", x.device,
        *(a.data_ptr() for a in args), hidden.data_ptr(), out.data_ptr(),
        B * S, D, Hd)
    return out
