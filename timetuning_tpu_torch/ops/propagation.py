"""k-NN label propagation over feature affinities.

Counterpart of ``timetuning_tpu/ops/propagation.py`` (reference
mask_propagation.py:396-496): affinity ``exp(<tar_norm, src_norm> / 0.1)``,
a per-context-frame neighbourhood mask, a *global* top-k over all context
keys per query (threshold by the k-th largest value, duplicates included),
renormalisation over the keys, then ``seg_tar = segs @ aff``. The context is
frame 0 (always) plus the ``n_last`` most recent propagated frames.

``propagate_labels_batch`` routes every clip batch to the propagation kernel
wrapper (ops/propagation_cuda), which launches the CUDA kernel for CUDA
tensors at any clip length and runs ``propagate_labels`` per clip for CPU
tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from timetuning_tpu_torch.ops.util import device_constant

_EPS = 1e-12


@functools.lru_cache(maxsize=16)
def _cached_neighborhood(h: int, w: int, radius: int):
    # copied from timetuning_tpu/ops/propagation.py:34-44 (that module imports jax)
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ii = ii.reshape(-1)
    jj = jj.reshape(-1)
    keep = (np.abs(ii[:, None] - ii[None, :]) <= radius) & (
        np.abs(jj[:, None] - jj[None, :]) <= radius
    )
    return keep.astype(np.float32)


def context_slots(T: int, n_last: int) -> int:
    """Rolling-context capacity for a T-frame clip: up to ``n_last`` recent
    propagated frames, at most the T-2 a clip produces before its last step,
    and at least 1. Copied from timetuning_tpu/ops/propagation.py:47-57; the
    plain path and the kernel both read it from here."""
    return max(min(n_last, T - 2), 1)


@device_constant
def neighborhood_mask(h: int, w: int, radius: int,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """[h*w, h*w] mask: 1 iff source s lies within a (2*radius+1)^2 window of
    query q. radius <= 0 -> all ones. Made once per (grid, radius, device)."""
    if radius <= 0:
        return torch.ones((h * w, h * w), dtype=torch.float32, device=device)
    return torch.from_numpy(_cached_neighborhood(h, w, radius)).to(device)


def kth_largest_value(x: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row k-th largest value along the last axis, duplicates counted:
    k masked-max passes (the reference thresholds by the top-k minimum,
    mask_propagation.py:434-436). Rows with fewer than k values give 0."""
    neg = torch.tensor(-torch.inf, dtype=x.dtype, device=x.device)
    t = torch.full(x.shape[:-1] + (1,), torch.inf, dtype=x.dtype, device=x.device)
    need = torch.full(x.shape[:-1] + (1,), k, dtype=torch.int64, device=x.device)
    kth = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    done = torch.zeros(x.shape[:-1] + (1,), dtype=torch.bool, device=x.device)
    for _ in range(k):
        below = x < t
        m = torch.where(below, x, neg).amax(dim=-1, keepdim=True)
        c = ((x == m) & below).sum(dim=-1, keepdim=True)
        take = ~done & (need <= c)
        kth = torch.where(take, m, kth)
        done = done | take
        need = need - c
        t = m
    return kth[..., 0]


def label_propagation_step(feat_tar, ctx_feats, ctx_segs, ctx_valid, nbhd,
                           topk: int = 5, temperature: float = 0.1):
    """Propagate context label maps onto one target frame. Returns [K, N].

    feat_tar [N, D] and ctx_feats [C, N, D] are L2-normalised; ctx_segs
    [C, K, N]; ctx_valid [C] is 1 for live slots; nbhd [N, N] is query-major.
    """
    C, N, _ = ctx_feats.shape
    acc_t = torch.promote_types(feat_tar.dtype, torch.float32)
    aff = torch.einsum("nd,cmd->cnm", feat_tar.to(acc_t), ctx_feats.to(acc_t))
    aff = torch.exp(aff / temperature)
    aff = aff * nbhd[None].to(acc_t)
    aff = aff * ctx_valid[:, None, None].to(acc_t)
    aff_q = aff.permute(1, 0, 2).reshape(N, C * N)
    kth = kth_largest_value(aff_q, topk)
    aff_q = torch.where(aff_q >= kth[:, None], aff_q, torch.zeros_like(aff_q))
    aff_q = aff_q / (aff_q.sum(dim=1, keepdim=True) + _EPS)
    segs = ctx_segs.permute(1, 0, 2).reshape(-1, C * N)
    return torch.einsum("kc,nc->kn", segs.to(acc_t), aff_q)


def _grid(N: int, spatial_size):
    if spatial_size is None:
        h = w = int(round(N ** 0.5))
    else:
        h, w = spatial_size
    if h * w != N:
        raise ValueError(f"spatial size {h}x{w} != N={N}")
    return h, w


def propagate_labels(features, first_seg, n_last: int = 7, radius: int = 6,
                     topk: int = 5, temperature: float = 0.1,
                     spatial_size: tuple[int, int] | None = None):
    """Propagate ``first_seg`` [K, N] through one clip's features [T, N, D].
    Returns [T-1, K, N] maps for frames 1..T-1. The context is a circular
    buffer of ``context_slots(T, n_last)`` recent frames plus frame 0."""
    T, N, D = features.shape
    K = first_seg.shape[0]
    h, w = _grid(N, spatial_size)
    nbhd = neighborhood_mask(h, w, radius, features.device)
    feats_n = features / (
        torch.linalg.vector_norm(features, dim=-1, keepdim=True) + _EPS)

    n_slots = context_slots(T, n_last)
    C = n_slots + 1
    seg_t = torch.promote_types(first_seg.dtype, torch.float32)
    ctx_feats = torch.zeros((C, N, D), dtype=feats_n.dtype, device=features.device)
    ctx_segs = torch.zeros((C, K, N), dtype=seg_t, device=features.device)
    ctx_valid = torch.zeros((C,), dtype=torch.float32, device=features.device)
    ctx_feats[0] = feats_n[0]
    ctx_segs[0] = first_seg.to(seg_t)
    ctx_valid[0] = 1.0
    segs = []
    for t in range(1, T):
        seg = label_propagation_step(feats_n[t], ctx_feats, ctx_segs, ctx_valid,
                                     nbhd, topk, temperature)
        slot = 1 + (t - 1) % n_slots
        ctx_feats[slot] = feats_n[t]
        ctx_segs[slot] = seg.to(seg_t)
        ctx_valid[slot] = 1.0
        segs.append(seg)
    return torch.stack(segs)


def propagate_labels_batch(features, first_seg, n_last: int = 7,
                           radius: int = 6, topk: int = 5,
                           temperature: float = 0.1,
                           spatial_size: tuple[int, int] | None = None):
    """Batched ``propagate_labels``: features [B, T, N, D], first_seg
    [B, K, N] -> [B, T-1, K, N] f32. CUDA tensors run the propagation kernel
    at every clip length; CPU tensors the plain scan."""
    from timetuning_tpu_torch.ops.propagation_cuda import (
        propagate_labels_batch_cuda,
    )

    return propagate_labels_batch_cuda(
        features, first_seg, n_last=n_last, radius=radius, topk=topk,
        temperature=temperature, spatial_size=spatial_size)
