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
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from timetuning_tpu_torch.ops.attention import WHOLE_SEQUENCE_TOKENS, attention
from timetuning_tpu_torch.ops.fused_block import (
    _ln,
    attention_block_branch,
    attention_block_branch_flash,
    mlp_block_branch,
    mlp_rows,
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

    def forward(self, x, return_probs: bool = False, impl: str = "auto", group=None):
        """``group``: the model axis of parallel/tp, whose ranks each hold
        their heads' q, k and v rows of ``qkv`` and the matching input
        columns of ``proj``; the probabilities, when asked for, are then
        every head's (gathered)."""
        B, S, D = x.shape
        Dh = D // self.num_heads
        qkv = _linear(copy_to_group(x, group), self.qkv)
        heads = qkv.shape[-1] // (3 * Dh)
        qkv = qkv.reshape(B, S, 3, heads, Dh)
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
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


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 qkv_bias: bool = True, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", moe: bool = False, n_experts: int = 0,
                 moe_capacity: float = 1.25):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        hidden = int(dim * mlp_ratio)
        if moe:
            # one routing group a sample: the dispatch stays linear in the
            # batch (one global group is quadratic in tokens, see MoEMlp)
            self.moe = MoEMlp(dim, n_experts, hidden, moe_capacity, group_size=-1)
        else:
            self.mlp = Mlp(dim, hidden)
        self.tp_group = None        # parallel/tp: the model axis's group

    def _mlp_branch(self, x):
        """LN2 + the MoE MLP + residual, in plain ops (JAX's
        ``Block._mlp_branch``)."""
        return x + self.moe(_ln(x, self.norm2.weight, self.norm2.bias))

    def forward(self, x, return_probs: bool = False,
                attn_impl: str | None = None):
        """``attn_impl`` overrides the block's own for this call. A block
        split over a model axis (``tp_group``, parallel/tp) runs the plain
        composition with the plain attention core, as under JAX's
        ``force_xla_attention``: the block kernels take whole weights."""
        g = self.tp_group
        impl = "xla" if g is not None else (
            self.attn_impl if attn_impl is None else attn_impl)
        moe = hasattr(self, "moe")
        if (impl in ("auto", "fused") and not return_probs
                and (self.dtype == torch.bfloat16 or impl == "fused")):
            a, dt = self.attn, self.dtype
            long = x.shape[1] > WHOLE_SEQUENCE_TOKENS
            attn_branch = attention_block_branch_flash if long else attention_block_branch
            mlp_branch = mlp_rows if long else mlp_block_branch
            x = attn_branch(
                x.to(dt), self.norm1.weight, self.norm1.bias,
                a.qkv.weight.t().to(dt), a.qkv.bias, a.proj.weight.t().to(dt),
                a.proj.bias, self.num_heads)
            if moe:
                return self._mlp_branch(x), None
            m = self.mlp
            x = mlp_branch(
                x, self.norm2.weight, self.norm2.bias, m.fc1.weight.t().to(dt),
                m.fc1.bias, m.fc2.weight.t().to(dt), m.fc2.bias)
            return x, None
        y, probs = self.attn(_ln(x, self.norm1.weight, self.norm1.bias),
                             return_probs=return_probs, impl=impl, group=g)
        x = x + y
        if moe:
            return self._mlp_branch(x), probs
        return x + self.mlp(_ln(x, self.norm2.weight, self.norm2.bias), group=g), probs


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
    ``attn_impl`` overrides the configuration's for this call.
    """

    def __init__(self, config: ViTConfig):
        super().__init__()
        c = config
        self.config = c
        self.patch_embed = PatchEmbed(c.patch_size, c.embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + (c.img_size // c.patch_size) ** 2, c.embed_dim))
        self.blocks = nn.ModuleList(
            Block(c.embed_dim, c.num_heads, c.mlp_ratio, c.qkv_bias, c.dtype,
                  c.attn_impl, moe=is_moe_block(c, i), n_experts=c.n_experts,
                  moe_capacity=c.moe_capacity_factor)
            for i in range(c.depth))
        self.norm = nn.LayerNorm(c.embed_dim, eps=1e-6)

    def init_weights(self, generator: torch.Generator) -> "VisionTransformer":
        """Seeded random init: truncated normal (std 0.02) for the CLS token
        and positional embedding, LeCun normal for projection and patch
        kernels and the experts' stacked FFNs, zero biases, unit LayerNorm
        scales."""
        with torch.no_grad():
            nn.init.trunc_normal_(self.cls_token, std=0.02, generator=generator)
            nn.init.trunc_normal_(self.pos_embed, std=0.02, generator=generator)
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
            x = x + interpolate_pos_embed(self.pos_embed, hp, wp,
                                          c.patch_size).to(dt)
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
                    block, x, want_attention and is_last, attn_impl,
                    use_reentrant=False)
            else:
                x, p_i = block(x, return_probs=want_attention and is_last,
                               attn_impl=attn_impl)
            if p_i is not None:
                probs = p_i
            if i >= c.depth - n_intermediates:
                interm.append(_ln(x, self.norm.weight, self.norm.bias))
        if stop < c.depth:
            return {"hidden": x, "grid": (hp, wp)}
        return {"tokens": interm[-1], "attention": probs,
                "intermediates": interm, "grid": (hp, wp)}
