"""DAVIS video-object-segmentation metrics: region J, boundary F, J&F.

Counterpart of ``timetuning_tpu/eval/vos.py`` (reference
mask_propagation.py:501-715: ``db_eval_boundary`` / ``_seg2bmap`` /
``db_eval_iou`` / ``db_statistics`` / ``evaluate_semisupervised``). The
per-frame metrics are torch tensor ops on the host; the sequence statistics
stay in numpy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from timetuning_tpu_torch.ops.morphology import dilate


def boundary_map(mask: torch.Tensor) -> torch.Tensor:
    """Binary boundary of [..., H, W] masks, as the reference ``_seg2bmap``
    (mask_propagation.py:614-627, the equal-size case): XOR against the
    east/south/southeast neighbours (zero-padded), then the last row and
    column are overridden to the east-/south-difference only and the corner
    to 0, so a full-frame mask has (almost) no boundary pixels."""
    m = mask.bool()
    e = torch.zeros_like(m)
    e[..., :, :-1] = m[..., :, 1:]
    s = torch.zeros_like(m)
    s[..., :-1, :] = m[..., 1:, :]
    se = torch.zeros_like(m)
    se[..., :-1, :-1] = m[..., 1:, 1:]
    b = (m ^ e) | (m ^ s) | (m ^ se)
    b[..., -1, :] = m[..., -1, :] ^ e[..., -1, :]
    b[..., :, -1] = m[..., :, -1] ^ s[..., :, -1]
    b[..., -1, -1] = False
    return b


def boundary_f_measure(pred: torch.Tensor, gt: torch.Tensor,
                       bound_th: float = 0.008) -> torch.Tensor:
    """F-measure of boundary alignment within a pixel tolerance (reference
    ``db_eval_boundary`` / ``f_measure``, mask_propagation.py:501-557).
    pred/gt: binary [..., H, W], each leading index a frame of its own,
    computed together on their device. Returns f32 [...] (0-d for one
    frame)."""
    H, W = pred.shape[-2:]
    bound_pix = (bound_th if bound_th >= 1
                 else math.ceil(bound_th * math.hypot(H, W)))
    fg = boundary_map(pred)
    gtb = boundary_map(gt)
    fg_dil = dilate(fg, int(bound_pix)).bool()
    gt_dil = dilate(gtb, int(bound_pix)).bool()

    n_fg = fg.sum(dim=(-2, -1)).float()
    n_gt = gtb.sum(dim=(-2, -1)).float()
    one = torch.ones((), device=pred.device)
    zero = torch.zeros((), device=pred.device)
    precision = torch.where(n_fg > 0, (fg & gt_dil).sum(dim=(-2, -1)) / n_fg.clamp(min=1),
                            torch.where(n_gt > 0, zero, one))
    recall = torch.where(n_gt > 0, (gtb & fg_dil).sum(dim=(-2, -1)) / n_gt.clamp(min=1),
                         torch.where(n_fg > 0, zero, one))
    denom = precision + recall
    return torch.where(denom > 0,
                       2 * precision * recall / denom.clamp(min=1e-12), zero)


def region_iou(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """DAVIS J per frame: |A and B| / |A or B|, empty/empty -> 1 (reference
    ``db_eval_iou``, mask_propagation.py:670-700)."""
    p = pred.bool()
    g = gt.bool()
    inter = (p & g).sum().float()
    union = (p | g).sum().float()
    return torch.where(union == 0, torch.ones(()), inter / union.clamp(min=1))


def evaluate_sequence(pred_masks: np.ndarray, gt_masks: np.ndarray,
                      obj_ids=None):
    """Per-object J & F over a sequence.

    pred/gt: [T, H, W] integer object-id maps (0 = background). Returns
    {object_id: {"J": [T], "F": [T]}} (reference ``evaluate_semisupervised``,
    mask_propagation.py:702-715). ``obj_ids``: the sequence's object set;
    pass it when the frames are a protocol slice (DAVIS scores masks[1:-1])
    so an object visible only in an excluded frame is still scored.
    """
    if len(gt_masks) == 0:
        return {}  # a 2-frame clip has no scoreable middle frames
    if obj_ids is None:
        obj_ids = [int(i) for i in np.unique(gt_masks) if i != 0]
    out = {}
    for oid in obj_ids:
        p = torch.from_numpy(np.asarray(pred_masks) == oid)
        g = torch.from_numpy(np.asarray(gt_masks) == oid)
        out[oid] = {
            "J": np.asarray([region_iou(a, b).item() for a, b in zip(p, g)],
                            np.float32),
            "F": np.asarray([boundary_f_measure(a, b).item()
                             for a, b in zip(p, g)], np.float32),
        }
    return out


def db_statistics(per_frame: np.ndarray):
    """(M, O, D): mean, recall@0.5, decay over 4 bins (reference
    ``db_statistics``, mask_propagation.py:641-666)."""
    M = float(np.mean(per_frame))
    O = float(np.mean(per_frame > 0.5))
    N = len(per_frame)
    ids = np.round(np.linspace(1, N, 5) + 1e-10) - 1
    ids = ids.astype(int)
    bins = [per_frame[ids[i]: ids[i + 1] + 1] for i in range(4)]
    D = float(np.mean(bins[0]) - np.mean(bins[3])) if N >= 4 else 0.0
    return M, O, D


def j_and_f(per_sequence: list[dict]) -> dict:
    """Aggregate J&F over sequences of ``evaluate_sequence`` outputs."""
    js, fs = [], []
    for seq in per_sequence:
        for _, d in seq.items():
            js.append(np.mean(d["J"]))
            fs.append(np.mean(d["F"]))
    J = float(np.mean(js)) if js else 0.0
    F = float(np.mean(fs)) if fs else 0.0
    return {"J": J, "F": F, "J&F": (J + F) / 2}
