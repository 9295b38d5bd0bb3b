"""Per-class boundary F-score (BF) between predicted and ground-truth
segmentations.

Counterpart of ``timetuning_tpu/eval/bfscore.py`` (reference bfscore.py:
per-class contours and boundary precision / recall within a pixel distance,
:21-167, and ``evaluate_bf_score`` over batches of foreground masks,
:297-320). Both go over ``eval/vos.boundary_f_measure`` (boundary map + disk
dilation), a batch in one call on the masks' device.
"""

from __future__ import annotations

import numpy as np
import torch

from timetuning_tpu_torch.eval.vos import boundary_f_measure


def bfscore(gt, pred, threshold: int = 2, num_classes: int | None = None):
    """Per-class boundary F of one frame. gt / pred: [H, W] integer class
    maps. Returns (scores {class: F, or None where the class is in neither
    map}, the mean over the scored classes). Class 0 (background) is
    skipped, as the reference's (bfscore.py:93-99)."""
    gt, pred = np.asarray(gt), np.asarray(pred)
    classes = sorted(set(np.unique(gt)) | set(np.unique(pred)))
    scores: dict[int, float | None] = {}
    vals = []
    for c in classes:
        if c == 0:
            continue
        g, p = gt == c, pred == c
        if not g.any() and not p.any():
            scores[int(c)] = None
            continue
        f = float(boundary_f_measure(torch.from_numpy(p), torch.from_numpy(g),
                                     bound_th=float(threshold)))
        scores[int(c)] = f
        vals.append(f)
    return scores, (float(np.mean(vals)) if vals else 0.0)


def evaluate_bf_score(gt_masks, fg_masks, threshold: int = 2) -> float:
    """Mean binary-foreground boundary F over a batch (reference
    bfscore.py:297-320). gt_masks / fg_masks: [N, H, W] binary, numpy or
    tensors; the batch is scored in one call on the masks' device (a
    tensor's, else the host)."""
    dev = next((m.device for m in (fg_masks, gt_masks) if torch.is_tensor(m)), "cpu")
    fg, gt = (torch.as_tensor(np.asarray(m) if not torch.is_tensor(m) else m,
                              device=dev).bool() for m in (fg_masks, gt_masks))
    return float(boundary_f_measure(fg, gt, float(threshold)).mean())
