"""The two residual branches of a ViT block, as hand-written CUDA kernels.

Up to 1024 tokens, one kernel a branch:

  * ``attention_block_branch``:  x + proj(attention(qkv(LN1(x))))
  * ``mlp_block_branch``:        x + fc2(gelu(fc1(LN2(x))))

Above 1024 tokens (``timetuning_tpu/ops/fused_block.py:270-449``), the row
kernels and the flash core:

  * ``attention_block_branch_flash``: ``ln_dense_rows`` (LN1 + qkv) ->
    ``ops/flash_attention`` -> ``dense_residual_rows`` (proj + residual);
  * ``mlp_rows``: LN2 + MLP + residual over the token rows.

Rows wider than the tile's LayerNorm prologue holds (D > ``GEMM_LN_K``,
DINOv2 ViT-g's 1,536) take a LayerNorm pass of their own
(``ln_wide_rows_kernel``) that feeds the streamed tile: ``ln_dense_rows``
does so there, counted as ``ln_wide_dense``. The SwiGLU MLP of DINOv2,
``swiglu_rows`` (``x + w3(silu(a) * b)``, ``[a | b] = w12(LN2(x))``), is
that pass, the tile's SwiGLU form (a tile holds 64 columns of each half of
``w12`` and writes only the product's hidden: ``gemm_swiglu_kernel_wide``,
three tiles a walk over K, where the rows fill the card, else
``gemm_swiglu_kernel`` by turns) and the residual product, at any token
count; a LayerScale is folded into the
residual product's weight and bias by the caller (models/vit).

Counterpart of ``timetuning_tpu/ops/fused_block.py``. Weights keep the JAX
package's layout, ``[in, out]`` (pass ``linear.weight.t()``). For a bf16
CUDA tensor a wrapper launches its kernel (csrc/attention_block.cu,
csrc/mlp_block.cu, csrc/rows_block.cu); for a CPU tensor it runs the plain
composition beside it (``attention_block_xla``, ``mlp_block_xla``,
``ln_dense_xla``, ``dense_residual_xla``, named after their JAX
counterparts). Every product of the plain versions is taken in f32 from its
operands' values, as the JAX compositions' ``preferred_element_type=f32``.
Each wrapper is a ``kernel_lib.kernel_entry``: under grad its backward is
JAX's custom VJP, the VJP of its plain version recomputed from the saved
inputs (``kernel_lib.plain_vjp``), and while ``torch.export`` traces it is
the custom op ``timetuning_tpu_torch::<name>``.

Every product of the kernels is one launch of the GEMM tile of
csrc/gemm_wgmma.cuh; ``gemm_plan`` says how the tile lays a product out on
the card (it is handed to the kernels, which check it), and the attention
core of ``attention_block_branch`` is kernel 10's, walked by
``ops/attention.mha_plan``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from timetuning_tpu_torch.ops import kernel_lib
from timetuning_tpu_torch.ops.attention import MHA_HEAD_DIMS, mha_plan
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


def mlp_hidden_xla(x, ln_s, ln_b, w1, b1):
    """``gelu(fc1(LN2(x)))``, bias and exact-erf GELU in f32, rounded to
    ``x``'s dtype once: the hidden of ``mlp_block_xla``."""
    h = _dot(_ln(x, ln_s, ln_b), w1) + b1
    return F.gelu(h, approximate="none").to(x.dtype)


def mlp_block_xla(x, ln_s, ln_b, w1, b1, w2, b2):
    out = _dot(mlp_hidden_xla(x, ln_s, ln_b, w1, b1), w2) + b2
    return x + out.to(x.dtype)


# The kernels' GELU (csrc/gemm_wgmma.cuh ``gelu_many``), one range and no
# branch: gelu(h) = max(h, 0) - t (2^p(t) - 2^p(6)) with t = min(|h|, 6) and
# p a polynomial for log2(Phi(-t)), Phi the normal distribution function
# (h Phi(h) = max(h, 0) - |h| Phi(-|h|)); the coefficients are a fit weighted
# by t Phi(-t), what an error of p costs the result. Above 6 it is h and
# below -6 it is 0, exactly; within, it is off by at most 3e-7.
GELU_CLAMP = 6.0
GELU_LOG2_TAIL = (-9.999930859e-01, -1.151201725e+00, -4.587709606e-01,
                  -5.341212451e-02, 8.080730215e-03, -7.692239597e-04,
                  3.309331805e-05)


def gelu_kernel_form(h):
    """The torch mirror of the kernels' GELU on f32 values: the same
    coefficients and the same order of operations (a multiply and an add
    where the kernel has one fused multiply-add)."""
    h = h.float()
    t = h.abs().clamp(max=GELU_CLAMP)

    def tail(t):
        p = torch.full_like(t, GELU_LOG2_TAIL[-1])
        for c in GELU_LOG2_TAIL[-2::-1]:
            p = p * t + c
        return torch.exp2(p)

    e = tail(t) - tail(torch.full((), GELU_CLAMP, dtype=torch.float32,
                                  device=h.device))
    return h.clamp(min=0) - t * e


def swiglu_hidden_xla(x, ln_s, ln_b, w12, b12):
    """``silu(a) * b`` with ``[a | b] = LN2(x) @ w12 + b12`` (the halves of
    the output), in f32 and rounded to ``x``'s dtype once: the hidden of
    ``swiglu_block_xla``."""
    a, g = (_dot(_ln(x, ln_s, ln_b), w12) + b12).chunk(2, dim=-1)
    return (F.silu(a) * g).to(x.dtype)


def swiglu_block_xla(x, ln_s, ln_b, w12, b12, w3, b3):
    return dense_residual_xla(swiglu_hidden_xla(x, ln_s, ln_b, w12, b12), x, w3, b3)


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


# The GEMM tile (csrc/gemm_wgmma.cuh): 128 output columns a tile, 64-wide K
# steps (one 128-byte swizzle atom of bf16 a row); with the LayerNorm
# prologue a block's rows stay resident in shared memory, 128 rows a block up
# to GEMM_LN_WIDE_K columns and 64 up to GEMM_LN_K. Its two forms: by turns
# (the short-K products, fc1 + GELU among them) and wide (a streamed product
# with the residual or the SwiGLU epilogue from GEMM_WIDE_K on that fills the
# card: fc2, w3, DINOv2's w12). Its epilogues, numbered as tt::Epilogue.
GEMM_TILE_COLS = 128
GEMM_K_STEP = 64
GEMM_LN_WIDE_K = 512
GEMM_LN_K = 1024
GEMM_WIDE_K = 1024
GEMM_WIDE_COLS = 3 * GEMM_TILE_COLS
GEMM_L2_SHARE = 20 * 2 ** 20     # of the card's L2 (50 MB on an H100)
EPI_BIAS, EPI_GELU, EPI_RESIDUAL, EPI_SWIGLU = range(4)
# the LayerNorm pass of rows wider than GEMM_LN_K (csrc/gemm_wgmma.cuh
# ln_wide_rows_kernel: a warp a row, the row in its registers)
LN_WIDE_MAX_K = 2048


class GemmPlan(NamedTuple):
    """How the tile runs ``out[M, N] = A[M, K] @ W[N, K]^T``: the rows of a
    block (``block_rows``), the output columns of a unit of work
    (``unit_cols``: a block walks whole units), and ``n_slices``, the work
    items a row block is cut into along its ``n_units`` units (``items``
    blocks in all)."""

    block_rows: int
    unit_cols: int
    n_units: int
    n_slices: int
    items: int


@functools.lru_cache(maxsize=256)
def gemm_plan(M: int, N: int, K: int, ln: bool, sms: int,
              epi: int = EPI_RESIDUAL) -> GemmPlan:
    """The plan of one product on a card of ``sms`` multiprocessors with the
    epilogue ``epi`` (``EPI_SWIGLU``: ``N`` is the product's 2 Hd columns).

    Rows a block and columns a unit, by K (mirrors ``tt::gemm::route``, to
    which the card's tests hold it): with the LayerNorm prologue (``ln``) the
    block's normalised rows stay resident in shared memory, 128 of them up to
    K = 512 and 64 up to 1,024; without it A streams through the ring with W,
    128 rows a block. A unit is one 128-column tile, except that a streamed
    product from K = 1,024 on with the residual (fc2) or the SwiGLU epilogue
    whose blocks fill the card at least once is wide, 384 columns a unit, one
    item a unit, so that the rows of A (the hidden, LN2's rows) are read once
    a unit and not once a tile (fewer row blocks go by turns, a slice a tile:
    measured on an H100, fc2 at 77 row blocks 0.0314 ms by turns against
    0.0355 wide, at 1,226 0.408 against 0.364).

    Slices of the other forms, by waves: a block costs its fill plus its
    units, and the card runs ``sms`` blocks at a time, so the count with the
    fewest waves x (fill + tiles a slice) wins, the smaller on a tie. The
    fill, measured on an H100 in tiles' worth of products: ~4.5 for the
    prologue (the rows' way in from device memory, then the LayerNorm), ~1
    for a streamed block (its ring's first stages); a tile with the GELU
    epilogue costs 1.25 (what of it shows beside the other warpgroup's
    products). 1,226 row blocks (ViT-S/8 at 448, 50 frames) keep one slice
    and so do 77 (ViT-S/16, 50 frames) without the GELU: cutting them repeats
    the prologue; with it, 77 row blocks of fc1's 12 tiles go in three slices
    (two waves of four tiles: 0.0474 ms against 0.0502 in one) and 197 in
    two (0.0896 against 0.1008). A streamed A by turns comes again
    from L2 for every tile of its row block; where a wave's blocks of A do
    not fit ``GEMM_L2_SHARE`` (ViT-B's proj: K = 768, 197 KB a block) a row
    block is cut into as many slices as it has tiles, which then run side by
    side and share one pass over A. A product without the residual (the
    streamed qkv of rows wider than the prologue holds, and their SwiGLU
    product on too few rows to go wide) takes the slices by waves there too, over the counts at which the row
    blocks a wave spans fit the share: a block of one tile leaves one of its
    two warpgroups without work."""
    if min(M, N, K, sms) < 1 or K % GEMM_K_STEP or N % 8:
        raise ValueError(f"gemm_plan: M={M}, N={N}, K={K}: the tile takes an "
                         f"inner width that is a multiple of {GEMM_K_STEP} "
                         "and an out width that is a multiple of 8")
    if ln and K > GEMM_LN_K:
        raise ValueError(f"gemm_plan: the LayerNorm prologue takes K <= "
                         f"{GEMM_LN_K}, got {K}")
    block_rows = 64 if ln and K > GEMM_LN_WIDE_K else 128
    row_blocks = -(-M // block_rows)
    n_units = -(-N // GEMM_WIDE_COLS)
    if (not ln and epi in (EPI_RESIDUAL, EPI_SWIGLU) and K >= GEMM_WIDE_K
            and -(-M // 128) * n_units >= sms):
        return GemmPlan(block_rows, GEMM_WIDE_COLS, n_units, n_units,
                        row_blocks * n_units)
    unit_cols = GEMM_TILE_COLS
    n_units = -(-N // unit_cols)
    a_bytes = block_rows * K * 2
    least = 1
    if not ln and min(row_blocks, sms) * a_bytes > GEMM_L2_SHARE:
        if epi == EPI_RESIDUAL:
            return GemmPlan(block_rows, unit_cols, n_units, n_units, row_blocks * n_units)
        # a wave of sms blocks spans sms / ns + 1 row blocks of A
        least = next((ns for ns in range(1, n_units + 1)
                      if (-(-sms // ns) + 1) * a_bytes <= GEMM_L2_SHARE), n_units)
    fill4 = 18 if ln else 4             # in quarter tiles
    tile4 = 5 if epi in (EPI_GELU, EPI_SWIGLU) else 4
    _, n_slices = min(
        (-(-row_blocks * ns // sms) * (fill4 + tile4 * -(-n_units // ns)), ns)
        for ns in range(least, n_units + 1))
    return GemmPlan(block_rows, unit_cols, n_units, n_slices,
                    row_blocks * n_slices)


def _slices(device, M, N, K, ln, epi=EPI_RESIDUAL) -> int:
    return gemm_plan(M, N, K, ln, kernel_lib.sm_count(device), epi).n_slices


# The fakes of the custom ops (kernel_lib.kernel_entry): each output is a
# new contiguous tensor in x's dtype, as the kernels' and the plain versions'.
def _like_x(x, *_):
    return x.new_empty(x.shape)


def _rows_fake(y, x, w, b):
    return x.new_empty(x.shape)


def _dense_fake(x, ln_s, ln_b, w, b):
    return x.new_empty(x.shape[:-1] + (w.shape[1],))


def _check_dense(name, D, w):
    """``w`` [D, E]: the GEMM tile takes D % 64 == 0 and E % 8 == 0."""
    if w.dim() != 2 or w.shape[0] != D or D % GEMM_K_STEP or w.shape[1] % 8:
        raise ValueError(f"{name}: weight shape {tuple(w.shape)} for D={D} "
                         f"(in width a multiple of {GEMM_K_STEP}, out width "
                         "of 8)")


@kernel_lib.kernel_entry(
    "attention_block_branch",
    "(Tensor x, Tensor ln_s, Tensor ln_b, Tensor w_qkv, "
    "Tensor? b_qkv, Tensor w_proj, Tensor? b_proj, int num_heads) -> Tensor",
    _like_x, kernel_lib.plain_vjp(attention_block_xla))
def attention_block_branch(x, ln_s, ln_b, w_qkv, b_qkv, w_proj, b_proj,
                           num_heads: int):
    """Kernel 1 (csrc/attention_block.cu). ``x``: [B, S, D] bf16."""
    if x.device.type == "cpu":
        return attention_block_xla(x, ln_s, ln_b, w_qkv, b_qkv, w_proj, b_proj,
                                   num_heads)
    _check_x("attention_block_branch", x)
    B, S, D = x.shape
    if D % num_heads or D // num_heads not in MHA_HEAD_DIMS[torch.bfloat16]:
        raise ValueError(f"attention_block_branch: the kernel takes 32- or "
                         f"64-wide heads, got D={D}, heads={num_heads}")
    if tuple(w_qkv.shape) != (D, 3 * D) or tuple(w_proj.shape) != (D, D):
        raise ValueError("attention_block_branch: weight shapes "
                         f"{tuple(w_qkv.shape)}, {tuple(w_proj.shape)} for D={D}")
    if D > GEMM_LN_K:
        raise ValueError(f"attention_block_branch: the LN prologue takes "
                         f"D <= {GEMM_LN_K}, got {D}")
    passes, keys = mha_plan(S)
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
        out.data_ptr(), B, S, D, num_heads,
        _slices(x.device, B * S, 3 * D, D, True),
        _slices(x.device, B * S, D, D, False), passes, keys)
    return out


def _mlp_weights(kernel, D, w1, w2):
    """fc1 [D, Hd] and fc2 [Hd, D] (either may be None) at widths the GEMM
    tile takes; returns Hd."""
    Hd = w1.shape[1] if w1 is not None else w2.shape[0]
    if ((w1 is not None and tuple(w1.shape) != (D, Hd))
            or (w2 is not None and tuple(w2.shape) != (Hd, D))
            or D % GEMM_K_STEP or Hd % GEMM_K_STEP or D > GEMM_LN_K):
        shapes = ", ".join(str(tuple(w.shape)) for w in (w1, w2) if w is not None)
        raise ValueError(f"{kernel}: weight shapes {shapes} for D={D} (widths "
                         f"must be multiples of {GEMM_K_STEP}, D <= {GEMM_LN_K})")
    return Hd


def _mlp_launch(kernel, x, ln_s, ln_b, w1, b1, w2, b2):
    """csrc/mlp_block.cu's two GEMMs over the B*S token rows, counted as
    ``kernel``."""
    _check_x(kernel, x)
    B, S, D = x.shape
    Hd = _mlp_weights(kernel, D, w1, w2)
    x = x.contiguous()
    args = [x, _f32(ln_s, D), _f32(ln_b, D), _weight_nk(w1), _f32(b1, Hd),
            _weight_nk(w2), _f32(b2, D)]
    kernel_lib.require_cuda(kernel, *args)
    hidden = torch.empty(B * S, Hd, dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    kernel_lib.launch(
        kernel, "tt_mlp_block", x.device,
        *(a.data_ptr() for a in args), hidden.data_ptr(), out.data_ptr(),
        B * S, D, Hd, _slices(x.device, B * S, Hd, D, True, EPI_GELU),
        _slices(x.device, B * S, D, Hd, False))
    return out


def mlp_hidden_rows(x, ln_s, ln_b, w1, b1):
    """The first launch of kernels 2 and 9 alone: the bf16 hidden
    ``gelu(fc1(LN2(x)))`` [B, S, Hd]. For the card's check of the hidden and
    the timing tools; it counts as no kernel's launch (the model calls
    ``mlp_block_branch`` / ``mlp_rows``)."""
    kernel_lib.require_no_grad("mlp_hidden_rows", x, ln_s, ln_b, w1, b1)
    if x.device.type == "cpu":
        return mlp_hidden_xla(x, ln_s, ln_b, w1, b1)
    _check_x("mlp_hidden_rows", x)
    B, S, D = x.shape
    Hd = _mlp_weights("mlp_hidden_rows", D, w1, None)
    args = [x.contiguous(), _f32(ln_s, D), _f32(ln_b, D), _weight_nk(w1),
            _f32(b1, Hd)]
    kernel_lib.require_cuda("mlp_hidden_rows", *args)
    hidden = torch.empty(B, S, Hd, dtype=torch.bfloat16, device=x.device)
    kernel_lib.launch(None, "tt_mlp_fc1", x.device,
                      *(a.data_ptr() for a in args), hidden.data_ptr(), B * S, D,
                      Hd, _slices(x.device, B * S, Hd, D, True, EPI_GELU))
    return hidden


def mlp_out_rows(hidden, x, w2, b2):
    """The second launch of kernels 2 and 9 alone: ``x + fc2(hidden)``, the
    sum in f32. Counts as no kernel's launch, as ``mlp_hidden_rows``."""
    kernel_lib.require_no_grad("mlp_out_rows", hidden, x, w2, b2)
    if x.device.type == "cpu":
        return dense_residual_xla(hidden, x, w2, b2)
    _check_x("mlp_out_rows", x)
    _check_x("mlp_out_rows", hidden)
    B, S, D = x.shape
    Hd = _mlp_weights("mlp_out_rows", D, None, w2)
    if tuple(hidden.shape) != (B, S, Hd):
        raise ValueError(f"mlp_out_rows: hidden {tuple(hidden.shape)} for "
                         f"[{B}, {S}, {Hd}]")
    args = [hidden.contiguous(), x.contiguous(), _weight_nk(w2), _f32(b2, D)]
    kernel_lib.require_cuda("mlp_out_rows", *args)
    out = torch.empty_like(x)
    kernel_lib.launch(None, "tt_mlp_fc2", x.device,
                      *(a.data_ptr() for a in args), out.data_ptr(), B * S, D, Hd,
                      _slices(x.device, B * S, D, Hd, False))
    return out


@kernel_lib.kernel_entry(
    "mlp_block_branch",
    "(Tensor x, Tensor ln_s, Tensor ln_b, Tensor w1, Tensor? b1, "
    "Tensor w2, Tensor? b2) -> Tensor",
    _like_x, kernel_lib.plain_vjp(mlp_block_xla))
def mlp_block_branch(x, ln_s, ln_b, w1, b1, w2, b2):
    """Kernel 2 (csrc/mlp_block.cu). ``x``: [B, S, D] bf16."""
    if x.device.type == "cpu":
        return mlp_block_xla(x, ln_s, ln_b, w1, b1, w2, b2)
    return _mlp_launch("mlp_block", x, ln_s, ln_b, w1, b1, w2, b2)


@kernel_lib.kernel_entry(
    "mlp_rows",
    "(Tensor x, Tensor ln_s, Tensor ln_b, Tensor w1, Tensor? b1, "
    "Tensor w2, Tensor? b2) -> Tensor",
    _like_x, kernel_lib.plain_vjp(mlp_block_xla))
def mlp_rows(x, ln_s, ln_b, w1, b1, w2, b2):
    """Kernel 9, the row-chunked LN2 + MLP + residual of sequences over 1024
    tokens (``_mlp_rows_pallas``, ``timetuning_tpu/ops/fused_block.py:350``).
    csrc/mlp_block.cu's GEMM tile is row-tiled already, so this launches it,
    counted as ``mlp_rows``. ``x``: [B, S, D] bf16."""
    if x.device.type == "cpu":
        return mlp_block_xla(x, ln_s, ln_b, w1, b1, w2, b2)
    return _mlp_launch("mlp_rows", x, ln_s, ln_b, w1, b1, w2, b2)


@kernel_lib.kernel_entry(
    "ln_dense_rows",
    "(Tensor x, Tensor ln_s, Tensor ln_b, Tensor w, Tensor? b) -> Tensor",
    _dense_fake, kernel_lib.plain_vjp(ln_dense_xla))
def ln_dense_rows(x, ln_s, ln_b, w, b):
    """Kernel 7 (csrc/rows_block.cu ``tt_ln_dense``): ``LN(x) @ w + b`` over
    the token rows (``_ln_dense_pallas``,
    ``timetuning_tpu/ops/fused_block.py:364``). ``x``: [B, S, D] bf16,
    ``w``: [D, E]."""
    if x.device.type == "cpu":
        return ln_dense_xla(x, ln_s, ln_b, w, b)
    _check_x("ln_dense_rows", x)
    B, S, D = x.shape
    _check_dense("ln_dense_rows", D, w)
    _check_ln_width("ln_dense_rows", D)
    E = w.shape[1]
    x = x.contiguous()
    args = [x, _f32(ln_s, D), _f32(ln_b, D), _weight_nk(w), _f32(b, E)]
    kernel_lib.require_cuda("ln_dense_rows", *args)
    out = torch.empty(B, S, E, dtype=torch.bfloat16, device=x.device)
    if D > GEMM_LN_K:
        # the LayerNorm pass into ``normed``, then the streamed tile
        normed = torch.empty_like(x)
        kernel_lib.launch("ln_wide_dense", "tt_ln_wide_dense", x.device,
                          *(a.data_ptr() for a in args), normed.data_ptr(),
                          out.data_ptr(), B * S, E, D,
                          _slices(x.device, B * S, E, D, False, EPI_BIAS))
        return out
    kernel_lib.launch("ln_dense", "tt_ln_dense", x.device,
                      *(a.data_ptr() for a in args), out.data_ptr(), B * S, E, D,
                      _slices(x.device, B * S, E, D, True))
    return out


def _check_ln_width(name, D):
    if D > LN_WIDE_MAX_K:
        raise ValueError(f"{name}: the LayerNorm takes D <= {LN_WIDE_MAX_K}, got {D}")


@kernel_lib.kernel_entry(
    "swiglu_rows",
    "(Tensor x, Tensor ln_s, Tensor ln_b, Tensor w12, Tensor? b12, "
    "Tensor w3, Tensor? b3) -> Tensor",
    _like_x, kernel_lib.plain_vjp(swiglu_block_xla))
def swiglu_rows(x, ln_s, ln_b, w12, b12, w3, b3):
    """LN2 + the SwiGLU MLP + residual over the token rows (csrc/mlp_block.cu
    ``tt_swiglu_mlp``, counted as ``swiglu_mlp``): the LayerNorm pass, the
    tile's SwiGLU form writing the bf16 hidden ``silu(a) * b`` [B*S, Hd], and
    ``x + hidden @ w3 + b3`` with the sum in f32. ``x``: [B, S, D] bf16,
    ``w12``: [D, 2 Hd] (``a`` the first Hd outputs), ``w3``: [Hd, D]. No
    JAX counterpart (DINOv2's ``SwiGLUFFNFused``)."""
    if x.device.type == "cpu":
        return swiglu_block_xla(x, ln_s, ln_b, w12, b12, w3, b3)
    _check_x("swiglu_rows", x)
    B, S, D = x.shape
    Hd = w3.shape[0]
    if (tuple(w12.shape) != (D, 2 * Hd) or tuple(w3.shape) != (Hd, D)
            or D % GEMM_K_STEP or Hd % GEMM_K_STEP):
        raise ValueError(f"swiglu_rows: weight shapes {tuple(w12.shape)}, "
                         f"{tuple(w3.shape)} for D={D} (widths must be multiples "
                         f"of {GEMM_K_STEP})")
    _check_ln_width("swiglu_rows", D)
    x = x.contiguous()
    args = [x, _f32(ln_s, D), _f32(ln_b, D), _weight_nk(w12), _f32(b12, 2 * Hd),
            _weight_nk(w3), _f32(b3, D)]
    kernel_lib.require_cuda("swiglu_rows", *args)
    normed = torch.empty_like(x)
    hidden = torch.empty(B * S, Hd, dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    kernel_lib.launch(
        "swiglu_mlp", "tt_swiglu_mlp", x.device,
        *(a.data_ptr() for a in args), normed.data_ptr(), hidden.data_ptr(),
        out.data_ptr(), B * S, D, Hd,
        _slices(x.device, B * S, 2 * Hd, D, False, EPI_SWIGLU),
        _slices(x.device, B * S, D, Hd, False))
    return out


@kernel_lib.kernel_entry(
    "dense_residual_rows",
    "(Tensor y, Tensor x, Tensor w, Tensor? b) -> Tensor",
    _rows_fake, kernel_lib.plain_vjp(dense_residual_xla))
def dense_residual_rows(y, x, w, b):
    """Kernel 8 (csrc/rows_block.cu ``tt_dense_residual``):
    ``x + (y @ w + b)``, the sum in f32, over the token rows
    (``_dense_residual_pallas``, ``timetuning_tpu/ops/fused_block.py:376``).
    ``y``: [B, S, K] bf16, ``x``: [B, S, E] bf16, ``w``: [K, E]."""
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
                      *(a.data_ptr() for a in args), out.data_ptr(), B * S, E, K,
                      _slices(y.device, B * S, E, K, False))
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
