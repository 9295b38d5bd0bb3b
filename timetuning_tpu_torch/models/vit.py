"""DINO-style Vision Transformer in PyTorch.

Counterpart of ``timetuning_tpu/models/vit.py`` (reference
dino_vision_transformer.py:108-294): dense patch tokens, last-block attention
probabilities on request, bicubic positional-embedding interpolation for any
input resolution. Parameter names follow the timm/DINO state dict, so a
reference ``.pth`` loads with ``load_state_dict``.

Dtype contract and routing, as the JAX ``Block`` (vit.py:228-273), by
``ViTConfig.attn_impl``. With ``auto`` a bf16 block runs its two residual
branches through the hand-written kernels (ops/fused_block; on a CPU tensor
their plain versions), the whole-block kernels up to 1024 tokens (the CLS
token counted) and the row kernels with the flash core above; an f32 block,
and any block asked for its attention probabilities, runs the plain
LayerNorm / Attention / MLP composition, whose attention core goes through
the dispatcher (ops/attention.attention), so an f32 block over 1024 tokens
on the card runs the flash kernel in f32. ``fused`` forces the block
kernels whatever the dtype; ``xla`` and ``pallas`` always run the
composition, with the plain attention core or with the attention kernels
(kernel 10 up to 1024 tokens; flash above). Every kernel route is
differentiable, with the JAX package's backward (the kernels' wrappers,
ops/fused_block and ops/attention); the train step's differentiated pass of
an ``auto`` model passes ``attn_impl="xla"`` per call by default
(core/timet.py), the counterpart of the JAX step's grad-path clone. With
``ViTConfig.remat`` each block is recomputed in the backward
(``torch.utils.checkpoint``), as the JAX ``nn.remat(Block)``. Parameters
stay f32 and are cast to the compute dtype where they are used.

Mixture of experts (``ViTConfig.moe_every_k`` / ``n_experts``, JAX
vit.py:45-58, 202-257): every k-th block's MLP is a Switch top-1
``parallel/ep.MoEMlp`` with one routing group a sample; its attention branch
is routed as any block's (kernel 1 in bf16), its MLP branch is plain ops
(JAX computes it in XLA, outside any kernel). Tensor parallelism
(parallel/tp): a block whose ``tp_group`` is set holds its heads' columns of
qkv, its hidden slice of fc1 and the matching rows of proj and fc2, and runs
the plain composition with one all-reduce at the end of each residual
branch (JAX's ``force_xla_attention``).

DINOv2 (Oquab et al. 2023, arXiv:2304.07193; registers, Darcet et al. 2023,
arXiv:2309.16588; ``facebookresearch/dinov2`` ``vision_transformer.py``),
the port's own addition with no JAX counterpart: ``ViTConfig.n_registers``
learned tokens inserted after the CLS token (no position), ``layerscale``
(``ls1`` / ``ls2``: per-channel scales of the two residual branches),
``ffn="swiglu"`` (``mlp.w12`` -> ``silu(a) * b`` -> ``mlp.w3``, the hidden
by ``swiglu_hidden``) and ``pos_resize="dinov2"`` (the stored grid resized
bicubically with antialias to the input's grid, by size). ``tokens``,
``intermediates`` and ``attention`` keep their meaning (CLS + patches): the
registers are taken out, and the final-norm registers come back under
``registers``. A bf16 block whose width passes what the tile's LayerNorm
prologue holds (``fused_block.GEMM_LN_K``) takes the row kernels at any
token count (their LayerNorm pass feeds the streamed tile); a SwiGLU MLP is
``fused_block.swiglu_rows``, and LayerScale is folded into ``proj`` / ``w3``
and their biases in f32 before the bf16 cast. A GELU MLP wider than the
prologue is ``mlp_rows``' wide route (the LayerNorm pass, the tile's
bias-GELU epilogue, fc2 + residual: SAM ViT-H's MLP at D 1,280,
models/sam.py).

DINOv3 (Simeoni et al. 2025, arXiv:2508.10104; ``facebookresearch/dinov3``
``dinov3/layers/rope_position_encoding.py``, ``attention.py``,
``ffn_layers.py``), the port's own too: 2-D axial RoPE of base
``rope_base`` on q and k of the patch tokens in place of learned positions
(the CLS token and the registers, ``storage_tokens`` in the hub's layout,
pass unrotated; v is never rotated), LayerNorm eps ``ln_eps``
(1e-5) and ``ffn="swiglu64"`` (DINOv3's ``SwiGLUFFN``: ``w1``, ``w2`` and
``w3``, the hidden rounded up to a multiple of 64; ``w1`` and ``w2`` are
held stacked as ``w12`` and ``state_dict`` gives them back apart). The RoPE
tables (``RopeEmbed``) depend only on the patch grid: ``prepare_grid``
makes them buffers of the model once (the serving export does, so its
program holds them), else a forward computes them. A bf16 RoPE block takes
``fused_block.attention_block_branch_rope`` at any token count (heads of
128: a tile of the qkv product is one head); an f32 block on the card runs
the plain composition, whose flash core takes heads of 128 in bf16 only and
raises.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from timetuning_tpu_torch.ops.attention import WHOLE_SEQUENCE_TOKENS, attention
from timetuning_tpu_torch.ops.fused_block import (
    _LN_EPS,
    GEMM_LN_K,
    _ln,
    attention_block_branch,
    attention_block_branch_flash,
    attention_block_branch_rope,
    mlp_block_branch,
    mlp_rows,
    rope_rows,
    swiglu_rows,
)
from timetuning_tpu_torch.parallel.ep import MoEMlp
from timetuning_tpu_torch.parallel.mesh import copy_to_group, gather_along, reduce_from_group


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 16
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    img_size: int = 224
    dtype: torch.dtype = torch.float32   # compute dtype; params stay f32
    attn_impl: str = "auto"              # auto | xla | pallas | fused
    remat: bool = False                  # recompute blocks in the backward
    # every k-th block's MLP a Switch MoE of n_experts expert FFNs (blocks
    # k-1, 2k-1, ...); 0/0 = dense everywhere (the reference architecture)
    moe_every_k: int = 0
    n_experts: int = 0
    moe_capacity_factor: float = 1.25
    # DINOv2 (module docstring): learned register tokens, LayerScale, the
    # SwiGLU MLP (its hidden width) and the position resize
    n_registers: int = 0
    layerscale: bool = False
    ffn: str = "mlp"                     # mlp | swiglu | swiglu64
    pos_resize: str = "dino"             # dino | dinov2
    # DINOv3 (module docstring): the RoPE base (0: learned positions, no
    # RoPE), the LayerNorm eps and the registers' parameter name
    rope_base: float = 0.0
    ln_eps: float = _LN_EPS
    register_name: str = "register_tokens"


def is_moe_block(cfg: ViTConfig, i: int) -> bool:
    return (cfg.moe_every_k > 0 and cfg.n_experts > 1
            and i % cfg.moe_every_k == cfg.moe_every_k - 1)


def vit_tiny(patch_size: int = 16, **kw) -> ViTConfig:
    return ViTConfig(patch_size=patch_size, embed_dim=192, depth=12,
                     num_heads=3, **kw)


def vit_small(patch_size: int = 16, **kw) -> ViTConfig:
    """DINO ViT-S, the reference's primary backbone (time_tuning.py:675)."""
    return ViTConfig(patch_size=patch_size, embed_dim=384, depth=12,
                     num_heads=6, **kw)


def vit_base(patch_size: int = 16, **kw) -> ViTConfig:
    return ViTConfig(patch_size=patch_size, embed_dim=768, depth=12,
                     num_heads=12, **kw)


def swiglu_hidden(dim: int, mlp_ratio: float = 4.0, align: int = 8) -> int:
    """The SwiGLU hidden width: two thirds of ``dim * mlp_ratio``, rounded up
    to a multiple of ``align`` (DINOv2's ``SwiGLUFFNFused``: 8, 4,096 at D
    1,536; DINOv3's "swiglu64": 64, 8,192 at D 4,096 and ratio 3)."""
    return (int(dim * mlp_ratio * 2 / 3) + align - 1) // align * align


def dinov2_giant_reg(patch_size: int = 14, **kw) -> ViTConfig:
    """DINOv2 ViT-g/14 with registers (``dinov2_vitg14_reg``:
    ``vit_giant2``, ``ffn_layer="swiglufused"``, 4 registers, positions
    stored at 518 and resized with antialias, offset 0)."""
    return ViTConfig(patch_size=patch_size, embed_dim=1536, depth=40, num_heads=24,
                     img_size=518, n_registers=4, layerscale=True, ffn="swiglu",
                     pos_resize="dinov2", **kw)


def dinov3_vit7b(patch_size: int = 16, **kw) -> ViTConfig:
    """DINOv3 ViT-7B/16 (``dinov3_vit7b16``: ``vit_7b``, D 4,096, 40 blocks,
    32 heads of 128, ``ffn_ratio`` 3 and "swiglu64", 4 storage tokens, no
    qkv bias, LayerScale, RoPE of base 100, LayerNorm eps 1e-5, no learned
    positions)."""
    return ViTConfig(patch_size=patch_size, embed_dim=4096, depth=40, num_heads=32,
                     mlp_ratio=3.0, qkv_bias=False, n_registers=4, layerscale=True,
                     ffn="swiglu64", rope_base=100.0, ln_eps=1e-5,
                     register_name="storage_tokens", **kw)


def rope_periods(head_dim: int, base: float) -> torch.Tensor:
    """DINOv3's periods, ``base ** (j / (head_dim / 4))`` for j < head_dim / 4
    (f32)."""
    n = head_dim // 4
    return base ** (2 * torch.arange(n, dtype=torch.float32) / (head_dim // 2))


def rope_table(periods: torch.Tensor, h: int, w: int):
    """The RoPE tables (cos, sin) [h * w, 4 len(periods)] of an h x w patch
    grid, rows in raster order (DINOv3's ``RopePositionEmbedding`` at eval,
    ``normalize_coords="separate"``): patch (r, c) at y = 2 (r + 1/2) / h - 1,
    x = 2 (c + 1/2) / w - 1; angles [2 pi y / p_j ..., 2 pi x / p_j ...]
    tiled twice. In f32 on the periods' device."""
    dev = periods.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h * 2 - 1
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w * 2 - 1
    coords = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1).flatten(0, 1)
    angles = 2 * math.pi * coords[:, :, None] / periods.float()[None, None, :]
    angles = angles.flatten(1, 2).tile(2)
    return torch.cos(angles), torch.sin(angles)


class RopeEmbed(nn.Module):
    """DINOv3's ``rope_embed``: its ``periods`` (a buffer of the hub's
    checkpoint) and the tables of a grid, made buffers by ``prepare``."""

    def __init__(self, head_dim: int, base: float):
        super().__init__()
        self.register_buffer("periods", rope_periods(head_dim, base))
        self.grid = None

    def prepare(self, h: int, w: int) -> None:
        cos, sin = rope_table(self.periods, h, w)
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)
        self.grid = (h, w)

    def table(self, h: int, w: int):
        if self.grid == (h, w):
            return self.cos, self.sin
        return rope_table(self.periods, h, w)


def interpolate_pos_embed(pos_embed: torch.Tensor, h_patches: int,
                          w_patches: int, patch_size: int) -> torch.Tensor:
    """Bicubic-resample the (non-CLS) positional grid to a new resolution,
    as reference ``interpolate_pos_encoding``
    (dino_vision_transformer.py:214-234): torch's bicubic (A=-0.75) with
    DINO's ``+0.1`` scale-factor fudge; the CLS position passes through."""
    from timetuning_tpu_torch.ops.resize import resize_bicubic_torch

    n = pos_embed.shape[1] - 1
    dim = pos_embed.shape[-1]
    n0 = int(round(n ** 0.5))
    if n0 * n0 == n and (h_patches, w_patches) == (n0, n0):
        return pos_embed
    grid = pos_embed[:, 1:].reshape(1, n0, n0, dim)
    grid = resize_bicubic_torch(
        grid, (h_patches, w_patches),
        scales=((h_patches + 0.1) / n0, (w_patches + 0.1) / n0))
    grid = grid.reshape(1, h_patches * w_patches, dim)
    return torch.cat([pos_embed[:, :1], grid], dim=1)


def interpolate_pos_embed_dinov2(pos_embed: torch.Tensor, h_patches: int,
                                 w_patches: int) -> torch.Tensor:
    """DINOv2's ``interpolate_pos_encoding`` with ``interpolate_offset=0``
    and ``interpolate_antialias=True``: the stored grid resized in f32 to
    (h_patches, w_patches) by size, bicubic with antialias; the CLS
    position passes through, and the stored grid is returned as it is."""
    n = pos_embed.shape[1] - 1
    dim = pos_embed.shape[-1]
    n0 = int(round(n ** 0.5))
    if (h_patches, w_patches) == (n0, n0):
        return pos_embed
    grid = pos_embed[:, 1:].float().reshape(1, n0, n0, dim).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(h_patches, w_patches), mode="bicubic",
                         antialias=True, align_corners=False)
    grid = grid.permute(0, 2, 3, 1).reshape(1, h_patches * w_patches, dim)
    return torch.cat([pos_embed[:, :1].float(), grid], dim=1).to(pos_embed.dtype)


def _linear(x, lin: nn.Linear):
    """``lin`` in ``x``'s dtype (Flax ``nn.Dense(dtype=...)`` semantics)."""
    b = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), b)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, patch_size)


def _row_linear(x, lin: nn.Linear, group):
    """``lin`` over a row-parallel slice of its input: the ranks' partial
    products summed over ``group`` and the (replicated) bias added once,
    after the sum; ``_linear`` without a group."""
    if group is None:
        return _linear(x, lin)
    return reduce_from_group(F.linear(x, lin.weight.to(x.dtype)), group) + lin.bias.to(x.dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, return_probs: bool = False, impl: str = "auto", group=None,
                rope=None):
        """``group``: the model axis of parallel/tp, whose ranks each hold
        their heads' q, k and v rows of ``qkv`` and the matching input
        columns of ``proj``; the probabilities, when asked for, are then
        every head's (gathered). ``rope``: (cos, sin, prefix), RoPE on q and
        k of the tokens from ``prefix`` on (``fused_block.rope_rows``)."""
        B, S, D = x.shape
        Dh = D // self.num_heads
        qkv = _linear(copy_to_group(x, group), self.qkv)
        heads = qkv.shape[-1] // (3 * Dh)
        qkv = qkv.reshape(B, S, 3, heads, Dh)
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        if rope is not None:
            q, k = (rope_rows(t, *rope) for t in (q, k))
        out, probs = attention(q, k, v, return_probs=return_probs, impl=impl)
        out = out.permute(0, 2, 1, 3).reshape(B, S, heads * Dh)
        if probs is not None:
            probs = gather_along(probs, 1, group)
        return _row_linear(out, self.proj, group), probs


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, group=None):
        """``group``: the model axis of parallel/tp (a rank's slice of the
        hidden: fc1's rows, fc2's input columns)."""
        h = F.gelu(_linear(copy_to_group(x, group), self.fc1), approximate="none")
        return _row_linear(h, self.fc2, group)


class SwiGLUMlp(nn.Module):
    """DINOv2's ``SwiGLUFFNFused``: ``w3(silu(a) * b)`` with ``[a | b] =
    w12(x)`` (the first and second halves of ``w12``'s outputs). ``split``:
    DINOv3's ``SwiGLUFFN`` layout, ``w3(silu(w1 x) * w2 x)``: ``w1`` and
    ``w2`` are held stacked as ``w12``, ``state_dict`` gives them apart and
    ``load_state_dict`` stacks them."""

    def __init__(self, dim: int, hidden: int, split: bool = False):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)
        if split:
            self.register_state_dict_post_hook(SwiGLUMlp._unstack)
            self.register_load_state_dict_pre_hook(SwiGLUMlp._stack)

    @staticmethod
    def _unstack(module, state_dict, prefix, local_metadata):
        for k in ("weight", "bias"):
            w1, w2 = state_dict.pop(f"{prefix}w12.{k}").chunk(2, dim=0)
            state_dict[f"{prefix}w1.{k}"], state_dict[f"{prefix}w2.{k}"] = w1, w2

    @staticmethod
    def _stack(module, state_dict, prefix, *_):
        for k in ("weight", "bias"):
            if f"{prefix}w1.{k}" in state_dict and f"{prefix}w2.{k}" in state_dict:
                state_dict[f"{prefix}w12.{k}"] = torch.cat(
                    [state_dict.pop(f"{prefix}w1.{k}"), state_dict.pop(f"{prefix}w2.{k}")])

    def forward(self, x, group=None):
        if group is not None:
            raise NotImplementedError("SwiGLUMlp: no tensor-parallel split")
        a, b = _linear(x, self.w12).chunk(2, dim=-1)
        return _linear(F.silu(a) * b, self.w3)


class LayerScale(nn.Module):
    """A residual branch's per-channel scale (DINOv2's ``ls1`` / ``ls2``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


def _scaled(lin: nn.Linear, ls: LayerScale | None):
    """``lin``'s f32 weight and bias with ``ls`` folded in (each output row
    and bias entry times its scale), as the kernels take them."""
    if ls is None:
        return lin.weight, lin.bias
    return lin.weight * ls.gamma[:, None], lin.bias * ls.gamma


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 qkv_bias: bool = True, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", moe: bool = False, n_experts: int = 0,
                 moe_capacity: float = 1.25, layerscale: bool = False,
                 ffn: str = "mlp", ln_eps: float = _LN_EPS):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        hidden = int(dim * mlp_ratio)
        if moe:
            # one routing group a sample: the dispatch stays linear in the
            # batch (one global group is quadratic in tokens, see MoEMlp)
            self.moe = MoEMlp(dim, n_experts, hidden, moe_capacity, group_size=-1)
        elif ffn == "swiglu":
            self.mlp = SwiGLUMlp(dim, swiglu_hidden(dim, mlp_ratio))
        elif ffn == "swiglu64":
            self.mlp = SwiGLUMlp(dim, swiglu_hidden(dim, mlp_ratio, 64), split=True)
        else:
            self.mlp = Mlp(dim, hidden)
        self.ls1 = LayerScale(dim) if layerscale else None
        self.ls2 = LayerScale(dim) if layerscale else None
        self.tp_group = None        # parallel/tp: the model axis's group

    def _ls(self, i: int, y):
        ls = self.ls1 if i == 1 else self.ls2
        return y if ls is None else ls(y)

    def _mlp_branch(self, x):
        """LN2 + the MoE MLP + residual, in plain ops (JAX's
        ``Block._mlp_branch``)."""
        return x + self.moe(_ln(x, self.norm2.weight, self.norm2.bias, self.norm2.eps))

    def forward(self, x, return_probs: bool = False,
                attn_impl: str | None = None, rope=None):
        """``attn_impl`` overrides the block's own for this call. A block
        split over a model axis (``tp_group``, parallel/tp) runs the plain
        composition with the plain attention core, as under JAX's
        ``force_xla_attention``: the block kernels take whole weights.
        ``rope``: (cos, sin, prefix) of a RoPE model (``Attention``)."""
        g = self.tp_group
        impl = "xla" if g is not None else (
            self.attn_impl if attn_impl is None else attn_impl)
        moe = hasattr(self, "moe")
        eps = self.norm1.eps
        if (impl in ("auto", "fused") and not return_probs
                and (self.dtype == torch.bfloat16 or impl == "fused")):
            a, dt = self.attn, self.dtype
            # the row kernels above 1024 tokens, and at any count for rows
            # wider than the tile's LayerNorm prologue holds
            wide = x.shape[-1] > GEMM_LN_K
            swiglu = not moe and isinstance(self.mlp, SwiGLUMlp)
            if eps != _LN_EPS and (rope is None or not swiglu):
                raise ValueError(f"Block: LayerNorm eps {eps} takes the RoPE and SwiGLU "
                                 f"kernels only (the tile's prologue holds {_LN_EPS})")
            w_proj, b_proj = _scaled(a.proj, self.ls1)
            if rope is not None:
                x = attention_block_branch_rope(
                    x.to(dt), self.norm1.weight, self.norm1.bias, a.qkv.weight.t().to(dt),
                    a.qkv.bias, w_proj.t().to(dt), b_proj, self.num_heads, *rope, eps)
            else:
                rows = x.shape[1] > WHOLE_SEQUENCE_TOKENS or wide
                attn_branch = attention_block_branch_flash if rows else attention_block_branch
                x = attn_branch(
                    x.to(dt), self.norm1.weight, self.norm1.bias,
                    a.qkv.weight.t().to(dt), a.qkv.bias, w_proj.t().to(dt),
                    b_proj, self.num_heads)
            if moe:
                return self._mlp_branch(x), None
            m = self.mlp
            if swiglu:
                w3, b3 = _scaled(m.w3, self.ls2)
                return swiglu_rows(
                    x, self.norm2.weight, self.norm2.bias, m.w12.weight.t().to(dt),
                    m.w12.bias, w3.t().to(dt), b3, eps), None
            w2, b2 = _scaled(m.fc2, self.ls2)
            mlp_branch = mlp_rows if x.shape[1] > WHOLE_SEQUENCE_TOKENS or wide \
                else mlp_block_branch
            x = mlp_branch(
                x, self.norm2.weight, self.norm2.bias, m.fc1.weight.t().to(dt),
                m.fc1.bias, w2.t().to(dt), b2)
            return x, None
        y, probs = self.attn(_ln(x, self.norm1.weight, self.norm1.bias, eps),
                             return_probs=return_probs, impl=impl, group=g, rope=rope)
        x = x + self._ls(1, y)
        if moe:
            return self._mlp_branch(x), probs
        y = self.mlp(_ln(x, self.norm2.weight, self.norm2.bias, eps), group=g)
        return x + self._ls(2, y), probs


class VisionTransformer(nn.Module):
    """DINO ViT. ``forward(x)`` with x: [B, H, W, 3] (NHWC, as the JAX
    package) returns a dict with
      ``tokens``        [B, 1+N, D] final-norm tokens (CLS first),
      ``attention``     [B, heads, 1+N, 1+N] last-block probabilities (only
                        with ``want_attention=True``, else None),
      ``intermediates`` the normed outputs of the last ``n_intermediates``
                        blocks,
      ``grid``          (h_patches, w_patches).

    ``start_block`` / ``stop_block`` run a sub-range of the blocks, so a
    frozen trunk is computed once and several tails fan out of it
    (core/timet.py): ``stop_block=k`` embeds and runs blocks [0, k),
    returning ``{"hidden": [B, 1+N, D], "grid": (hp, wp)}`` before the final
    norm; ``start_block=k`` takes such hidden tokens as ``x`` and runs blocks
    [k, depth) and the final norm (its ``grid`` is (None, None)).
    ``attn_impl`` overrides the configuration's for this call. With
    ``n_registers`` the registers sit after the CLS token in ``hidden`` and
    are taken out of ``tokens``, ``intermediates`` and ``attention``;
    ``registers`` [B, R, D] holds them, final-normed. A RoPE model's later
    blocks (``start_block > 0``) take the grid ``prepare_grid`` made.
    """

    def __init__(self, config: ViTConfig):
        super().__init__()
        c = config
        self.config = c
        self.patch_embed = PatchEmbed(c.patch_size, c.embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.embed_dim))
        if not c.rope_base:
            self.pos_embed = nn.Parameter(
                torch.zeros(1, 1 + (c.img_size // c.patch_size) ** 2, c.embed_dim))
        if c.n_registers:
            setattr(self, c.register_name,
                    nn.Parameter(torch.zeros(1, c.n_registers, c.embed_dim)))
        if c.rope_base:
            self.rope_embed = RopeEmbed(c.embed_dim // c.num_heads, c.rope_base)
        self.blocks = nn.ModuleList(
            Block(c.embed_dim, c.num_heads, c.mlp_ratio, c.qkv_bias, c.dtype,
                  c.attn_impl, moe=is_moe_block(c, i), n_experts=c.n_experts,
                  moe_capacity=c.moe_capacity_factor, layerscale=c.layerscale,
                  ffn=c.ffn, ln_eps=c.ln_eps)
            for i in range(c.depth))
        self.norm = nn.LayerNorm(c.embed_dim, eps=c.ln_eps)

    @property
    def registers(self) -> nn.Parameter:
        return getattr(self, self.config.register_name)

    def prepare_grid(self, h: int, w: int) -> None:
        """Make the RoPE tables of an h x w patch grid buffers of the model
        (a forward at that grid reads them; nothing without RoPE)."""
        if self.config.rope_base:
            self.rope_embed.prepare(h, w)

    def init_weights(self, generator: torch.Generator) -> "VisionTransformer":
        """Seeded random init: truncated normal (std 0.02) for the CLS token,
        the positional embedding and the registers, LeCun normal for
        projection and patch kernels and the experts' stacked FFNs, zero
        biases, unit LayerNorm and LayerScale scales."""
        with torch.no_grad():
            nn.init.trunc_normal_(self.cls_token, std=0.02, generator=generator)
            if not self.config.rope_base:
                nn.init.trunc_normal_(self.pos_embed, std=0.02, generator=generator)
            if self.config.n_registers:
                nn.init.trunc_normal_(self.registers, std=0.02, generator=generator)
            for mod in self.modules():
                if isinstance(mod, (nn.Linear, nn.Conv2d)):
                    fan_in = mod.weight[0].numel()
                    nn.init.trunc_normal_(mod.weight, std=fan_in ** -0.5,
                                          a=-2 * fan_in ** -0.5,
                                          b=2 * fan_in ** -0.5,
                                          generator=generator)
                    if mod.bias is not None:
                        nn.init.zeros_(mod.bias)
                elif isinstance(mod, nn.LayerNorm):
                    nn.init.ones_(mod.weight)
                    nn.init.zeros_(mod.bias)
                elif isinstance(mod, MoEMlp):
                    mod.init_experts(generator)
                elif isinstance(mod, LayerScale):
                    nn.init.ones_(mod.gamma)
        return self

    def forward(self, x: torch.Tensor, want_attention: bool = False,
                n_intermediates: int = 1, start_block: int = 0,
                stop_block: int | None = None, attn_impl: str | None = None):
        c = self.config
        dt = c.dtype
        hp = wp = None
        if start_block == 0:
            B = x.shape[0]
            pe = self.patch_embed.proj
            x = F.conv2d(x.permute(0, 3, 1, 2).to(dt), pe.weight.to(dt),
                         pe.bias.to(dt), stride=c.patch_size)
            hp, wp = x.shape[2], x.shape[3]
            x = x.flatten(2).transpose(1, 2)
            x = torch.cat([self.cls_token.expand(B, 1, c.embed_dim).to(dt), x],
                          dim=1)
            if not c.rope_base:
                if c.pos_resize == "dinov2":
                    pos = interpolate_pos_embed_dinov2(self.pos_embed, hp, wp)
                else:
                    pos = interpolate_pos_embed(self.pos_embed, hp, wp, c.patch_size)
                x = x + pos.to(dt)
            if c.n_registers:
                reg = self.registers.expand(B, c.n_registers, c.embed_dim)
                x = torch.cat([x[:, :1], reg.to(dt), x[:, 1:]], dim=1)
        rope = None
        if c.rope_base:
            grid = (hp, wp) if start_block == 0 else self.rope_embed.grid
            prefix = 1 + c.n_registers
            if grid is None or grid[0] * grid[1] != x.shape[1] - prefix:
                raise ValueError(f"VisionTransformer: no RoPE grid for {x.shape[1]} tokens "
                                 "(prepare_grid makes one for later blocks)")
            rope = (*self.rope_embed.table(*grid), prefix)
        stop = c.depth if stop_block is None else stop_block
        interm = []
        probs = None
        for i in range(start_block, stop):
            is_last = i == c.depth - 1
            block = self.blocks[i]
            if c.remat and torch.is_grad_enabled():
                # JAX's nn.remat(Block) (timetuning_tpu/models/vit.py:344):
                # the block's activations are recomputed in the backward
                x, p_i = torch.utils.checkpoint.checkpoint(
                    block, x, want_attention and is_last, attn_impl, rope,
                    use_reentrant=False)
            else:
                x, p_i = block(x, return_probs=want_attention and is_last,
                               attn_impl=attn_impl, rope=rope)
            if p_i is not None:
                probs = p_i
            if i >= c.depth - n_intermediates:
                interm.append(_ln(x, self.norm.weight, self.norm.bias, c.ln_eps))
        if stop < c.depth:
            return {"hidden": x, "grid": (hp, wp)}
        R = c.n_registers
        if not R:
            return {"tokens": interm[-1], "attention": probs,
                    "intermediates": interm, "grid": (hp, wp)}
        # the registers out of CLS + patches (and of both token axes of the
        # probabilities); the final-norm registers under their own key
        regs = interm[-1][:, 1:1 + R]
        interm = [torch.cat([t[:, :1], t[:, 1 + R:]], dim=1) for t in interm]
        if probs is not None:
            keep = torch.cat([torch.zeros(1, dtype=torch.long),
                              torch.arange(1 + R, probs.shape[-1])]).to(probs.device)
            probs = probs[:, :, keep][..., keep]
        return {"tokens": interm[-1], "attention": probs, "intermediates": interm,
                "registers": regs, "grid": (hp, wp)}
