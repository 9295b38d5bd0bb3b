"""Sequence parallelism for the dense-feature forward of a ViT.

Counterpart of ``timetuning_tpu/parallel/sp.py`` (beyond the reference,
which runs S/8 at 448, 3,137 tokens, as one big attention on one GPU): the
TOKEN axis is split over the inner axis of a ``(data, seq)`` mesh, so one
forward's activations and attention split across devices.

All-gather-K/V sequence parallelism, as JAX's:

  * the embedding runs on this rank's data slice; the tokens are padded to a
    multiple of ``sp`` and the rank keeps its contiguous slab ``[B/dp,
    Sp/sp, D]`` (the CLS token rides slab 0: attention is global);
  * every per-token op of a block runs on the slab, in bf16 through the
    kernels of the single-device long branch: K7 (``ln_dense_rows``, LN1 +
    qkv), the flash core K5/6 with local queries against the gathered keys,
    K8 (``dense_residual_rows``, proj + residual), and K2
    (``mlp_block_branch``) on slabs of at most 1,024 rows, K9 (``mlp_rows``)
    above (JAX's ``_mlp_dispatch`` on the slab's length); in f32 the block's
    plain products with the flash core's f32 form, as the single-device f32
    block over 1,024 tokens runs them;
  * K and V are all-gathered over ``seq`` once a block
    (``parallel/mesh.all_gather_along``: one all-reduce of a zero-scattered
    ``[B/dp, Sp, 2, H, Dh]`` buffer, reduce-scatter backward), the padded
    tail masked by ``kv_len`` and the padded query rows sliced off;
  * the final norm runs on the slab; one all-gather of the slabs over
    ``seq`` gives each rank its data slice's ``1 + N`` tokens (JAX's
    ``out_specs=P('data')``).

The backward is JAX's: the parameter gradients of a loss on each rank's
output, summed over the mesh, are the single-device gradients
(tests/test_torch_sp.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from timetuning_tpu_torch.models.vit import VisionTransformer, _linear
from timetuning_tpu_torch.ops import fused_block as fb
from timetuning_tpu_torch.ops.attention import WHOLE_SEQUENCE_TOKENS
from timetuning_tpu_torch.ops.flash_attention import flash_attention
from timetuning_tpu_torch.parallel.mesh import (
    Mesh2D,
    all_gather_along,
    gather_along,
    make_2d_mesh,
)

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def make_dp_sp_mesh(dp: int, sp: int, devices=None) -> Mesh2D:
    """2-D (data, seq) mesh, ``seq`` over consecutive ranks."""
    return make_2d_mesh(dp, sp, (DATA_AXIS, SEQ_AXIS), devices=devices)


def _block(blk, x, group, kv_len: int | None):
    """One block over a local slab ``x`` [Bl, Sl, D]: the single-device long
    branch with the keys and values gathered over ``group``."""
    B, Sl, D = x.shape
    H = blk.num_heads
    a, n1, n2 = blk.attn, blk.norm1, blk.norm2
    kernels = x.dtype == torch.bfloat16
    dt = x.dtype
    if kernels:
        qkv = fb.ln_dense_rows(x, n1.weight, n1.bias, a.qkv.weight.t().to(dt), a.qkv.bias)
    else:
        qkv = _linear(fb._ln(x, n1.weight, n1.bias), a.qkv)
    qkv = qkv.reshape(B, Sl, 3, H, D // H)
    kv = all_gather_along(qkv[:, :, 1:], 1, group)         # [B, Sp, 2, H, Dh]
    q = qkv[:, :, 0].permute(0, 2, 1, 3)
    k, v = (kv[:, :, i].permute(0, 2, 1, 3) for i in range(2))
    merged = flash_attention(q, k, v, kv_len).permute(0, 2, 1, 3).reshape(B, Sl, D)
    if not kernels:
        x = x + _linear(merged, a.proj)
        return x + blk.mlp(fb._ln(x, n2.weight, n2.bias))
    x = fb.dense_residual_rows(merged, x, a.proj.weight.t().to(dt), a.proj.bias)
    m = blk.mlp
    mlp = fb.mlp_block_branch if Sl <= WHOLE_SEQUENCE_TOKENS else fb.mlp_rows
    return mlp(x, n2.weight, n2.bias, m.fc1.weight.t().to(dt), m.fc1.bias,
               m.fc2.weight.t().to(dt), m.fc2.bias)


def sp_forward_fn(model, mesh: Mesh2D):
    """The sequence-parallel forward of ``model`` (a ``VisionTransformer``)
    on ``mesh`` (``make_dp_sp_mesh``), differentiable: ``fwd(images)`` takes
    this rank's data slice [B/dp, H, W, 3] and returns its final-norm tokens
    [B/dp, 1 + N, D], the same on every rank of a seq group. Any token count
    works: the padding is masked out of attention and sliced off."""
    if mesh.coords is None:
        raise ValueError("sp_forward_fn: this rank is not on the mesh")
    if not isinstance(model, VisionTransformer):
        raise ValueError(f"sequence parallelism runs the port's VisionTransformer; a "
                         f"{type(model).__name__} runs on one device")
    if getattr(model.config, "rope_base", 0):
        raise ValueError("sequence parallelism runs ViTs with learned positions; a "
                         "RoPE ViT (DINOv3) runs on one device")
    if any(hasattr(b, "moe") for b in model.blocks):
        raise ValueError("sequence parallelism runs dense ViT blocks; a MoE ViT "
                         "shards its experts instead (parallel/ep.py)")
    n_seq, group, r = mesh.n_inner, mesh.inner, mesh.inner_index

    def fwd(images):
        h = model(images, stop_block=0)["hidden"]            # [B, 1 + N, D]
        B, S, D = h.shape
        Sl = -(-S // n_seq)
        x = F.pad(h, (0, 0, 0, Sl * n_seq - S))[:, r * Sl:(r + 1) * Sl]
        kv_len = None if Sl * n_seq == S else S
        for blk in model.blocks:
            x = _block(blk, x, group, kv_len)
        x = fb._ln(x, model.norm.weight, model.norm.bias)
        return gather_along(x, 1, group)[:, :S]

    return fwd


def make_sp_feature_fn(model, mesh: Mesh2D):
    """``sp_forward_fn`` with no gradient: ``fwd(images)`` -> this rank's
    data slice's tokens."""
    fwd = sp_forward_fn(model, mesh)

    @torch.no_grad()
    def feature_fn(images):
        return fwd(images)

    return feature_fn
