"""The label-propagation kernel (csrc/propagation.cu) and its plain version.

Counterpart of ``timetuning_tpu/ops/propagation_pallas.py``. The TPU kernel
is gated to clips of at most 8 frames there, only because its Mosaic compile
time grows with T; this kernel has no such gate and serves the 25-frame eval
clips too, at any patch count: with a neighbourhood radius r its scratch rows
hold only the (2r+1)^2 window of each context frame (0.94 GB a clip at
ViT-S/8's 56x56 patches, r = 12, T = 25).
"""

from __future__ import annotations

import torch

from timetuning_tpu_torch.ops import kernel_lib
from timetuning_tpu_torch.ops.propagation import (
    _EPS,
    _grid,
    context_slots,
    propagate_labels,
)


def propagate_labels_batch_plain(features, first_seg, n_last: int = 7,
                                 radius: int = 6, topk: int = 5,
                                 temperature: float = 0.1,
                                 spatial_size: tuple[int, int] | None = None):
    """The plain version: ``propagate_labels`` clip by clip."""
    return torch.stack([
        propagate_labels(f, s, n_last=n_last, radius=radius, topk=topk,
                         temperature=temperature, spatial_size=spatial_size)
        for f, s in zip(features, first_seg)
    ])


def propagate_labels_batch_cuda(features, first_seg, n_last: int = 7,
                                radius: int = 6, topk: int = 5,
                                temperature: float = 0.1,
                                spatial_size: tuple[int, int] | None = None):
    """Kernel 3. features [B, T, N, D] (any float dtype: normalised in that
    dtype, then read as f32), first_seg [B, K, N] -> [B, T-1, K, N] f32."""
    kernel_lib.require_no_grad("propagate_labels_batch", features, first_seg)
    if features.device.type == "cpu":
        return propagate_labels_batch_plain(
            features, first_seg, n_last=n_last, radius=radius, topk=topk,
            temperature=temperature, spatial_size=spatial_size)
    if features.dim() != 4 or first_seg.dim() != 3:
        raise ValueError(f"propagate_labels_batch: expected [B, T, N, D] and "
                         f"[B, K, N], got {tuple(features.shape)}, "
                         f"{tuple(first_seg.shape)}")
    B, T, N, D = features.shape
    K = first_seg.shape[1]
    if first_seg.shape[0] != B or first_seg.shape[2] != N or T < 2:
        raise ValueError(f"propagate_labels_batch: shapes "
                         f"{tuple(features.shape)} / {tuple(first_seg.shape)}")
    if D % 32:
        raise ValueError(f"propagate_labels_batch: the kernel takes D % 32 == 0, "
                         f"got D={D}")
    _, w = _grid(N, spatial_size)
    feats_n = features / (
        torch.linalg.vector_norm(features, dim=-1, keepdim=True) + _EPS)
    feats_n = feats_n.float().contiguous()
    seg0 = first_seg.float().contiguous()
    kernel_lib.require_cuda("propagate_labels_batch", feats_n, seg0)
    n_slots = context_slots(T, n_last)
    radius = max(int(radius), 0)         # the plain mask: radius <= 0 is no mask
    # the normalised affinity rows of every target frame; a row's length is
    # the kernel's (the window or the whole frame, csrc/propagation.cu)
    row = kernel_lib.library().tt_propagate_row_floats(T, N, n_slots, radius)
    rows = torch.empty((B, T - 1, N, row), dtype=torch.float32,
                       device=features.device)
    out = torch.empty((B, T - 1, K, N), dtype=torch.float32,
                      device=features.device)
    kernel_lib.launch(
        "propagation", "tt_propagate_labels", features.device,
        feats_n.data_ptr(), seg0.data_ptr(), rows.data_ptr(), out.data_ptr(),
        B, T, N, D, K, n_slots, w, radius, topk, rows.shape[-1],
        float(temperature))
    return out
