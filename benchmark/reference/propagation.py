"""The plain reference of label propagation and of the Sinkhorn assignment.

Propagation (Jabri et al. 2020, as TimeT's ``mask_propagation.py``
propagates): each target frame's patches take the labels of their top-k
most similar keys, by ``exp(cos / 0.1)``, among the context frames (frame
0 and the most recent propagated ones), inside a (2r + 1)^2 window, the k
weights renormalised. Batched over clips, in f32.

Sinkhorn-Knopp (Cuturi 2013; SwAV's and TimeT's ``find_optimal_assignment``):
``Q = exp(scores / eps)``, normalised to unit mass, then alternately rows
to 1 / K and columns to 1 / B, and each sample's row rescaled to sum to 1.

Imports nothing of the program, of JAX, or of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-12


def window_mask(h: int, w: int, radius: int, device) -> torch.Tensor:
    """[h*w, h*w]: 1 where key s lies within ``radius`` of query q on both
    axes (all ones for radius <= 0)."""
    if radius <= 0:
        return torch.ones(h * w, h * w, device=device)
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    keep = (np.abs(ii[:, None] - ii[None, :]) <= radius) & (
        np.abs(jj[:, None] - jj[None, :]) <= radius)
    return torch.from_numpy(keep.astype(np.float32)).to(device)


def propagate(features: torch.Tensor, first_seg: torch.Tensor, n_last: int,
              radius: int, topk: int, temperature: float = 0.1) -> torch.Tensor:
    """features [B, T, N, D], first_seg [B, K, N] -> [B, T-1, K, N] label maps
    of frames 1..T-1. The context: frame 0 and the last
    ``max(min(n_last, T - 2), 1)`` propagated frames."""
    B, T, N, D = features.shape
    side = int(round(N ** 0.5))
    nb = window_mask(side, side, radius, features.device)
    f = features.float()
    f = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + _EPS)
    slots = max(min(n_last, T - 2), 1)
    ctx_f = [f[:, 0]]
    ctx_s = [first_seg.float()]
    out = []
    for t in range(1, T):
        cf = torch.stack(ctx_f, dim=1)                         # [B, C, N, D]
        cs = torch.stack(ctx_s, dim=1)                         # [B, C, K, N]
        aff = torch.exp(torch.einsum("bnd,bcmd->bncm", f[:, t], cf) / temperature)
        aff = (aff * nb[None, :, None, :]).reshape(B, N, -1)   # [B, N, C*N]
        kth = torch.topk(aff, topk, dim=-1).values[..., -1:]
        aff = torch.where(aff >= kth, aff, torch.zeros_like(aff))
        aff = aff / (aff.sum(dim=-1, keepdim=True) + _EPS)
        segs = cs.permute(0, 2, 1, 3).reshape(B, cs.shape[2], -1)   # [B, K, C*N]
        seg = torch.einsum("bkc,bnc->bkn", segs, aff)
        out.append(seg)
        # the rolling context: frame 0 stays, the oldest propagated frame goes
        ctx_f.append(f[:, t])
        ctx_s.append(seg)
        if len(ctx_f) > slots + 1:
            del ctx_f[1], ctx_s[1]
    return torch.stack(out, dim=1)


def sinkhorn(scores: torch.Tensor, epsilon: float = 0.05, n_iters: int = 10) -> torch.Tensor:
    """scores [B, K] -> the assignment [B, K] (rows sum to 1)."""
    Q = torch.exp(scores.double() / epsilon).t()               # [K, B]
    Q = Q / Q.sum()
    K, B = Q.shape
    for _ in range(n_iters):
        Q = Q / Q.sum(dim=1, keepdim=True) / K
        Q = Q / Q.sum(dim=0, keepdim=True) / B
    Q = Q / Q.sum(dim=0, keepdim=True)
    return Q.t().float()
