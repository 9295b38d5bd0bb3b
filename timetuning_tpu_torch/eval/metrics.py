# The port's own copy of timetuning_tpu/eval/metrics.py (host code: numpy, no JAX), with its
# imports of the package renamed; tests/test_torch_host_copies.py pins it to the original.
"""Unsupervised-segmentation mIoU with Hungarian / many-to-one matching.

Re-designs the reference ``PredsmIoU`` (metrics.py:209-505) for TPU:

  * ``update`` accumulates a single [num_gt, num_pred] confusion matrix
    (one vectorized ``bincount`` of the joint label per call). The reference
    instead kept *every flattened pixel* in host lists and later computed a
    joblib-parallel score matrix with one full array scan per (gt, pred)
    pair (metrics.py:458-479) — the confusion matrix contains identical
    information at a vanishing fraction of the cost.
  * ``compute`` pulls the (tiny) confusion matrix to host and reproduces the
    reference matching semantics exactly: IoU or precision score matrix over
    the *observed* classes, Hungarian matching via the native C++ solver
    (timetuning_tpu_torch.native; reference used scipy, metrics.py:481-488) or
    greedy many-to-one (metrics.py:490-505), unmatched predictions → background,
    per-class IoU with optional background exclusion (``involve_bg``),
    fraction-of-clusters-matched-to-bg statistic.

The returned ``mapping`` (pred class → matched gt class) replaces the
reference's full ``reordered_preds`` pixel array; ``remap()`` reconstructs it
on demand for visualization.
"""

from __future__ import annotations

import numpy as np

from timetuning_tpu_torch.native import hungarian as linear_sum_assignment


def confusion_matrix(
    gt: np.ndarray, pred: np.ndarray, num_gt: int, num_pred: int
) -> np.ndarray:
    """[num_gt, num_pred] confusion matrix as ONE vectorized bincount.

    Host-side on purpose: the inputs arrive as (often ignore-filtered,
    data-dependent-length) numpy label arrays — a jitted device bincount
    would retrace per distinct length (one compile per frame on Pascal val)
    and pay a transfer each way, for a memory-bound op numpy does in
    milliseconds at dataset scale."""
    joint = (
        np.asarray(gt).reshape(-1).astype(np.int64) * num_pred
        + np.asarray(pred).reshape(-1).astype(np.int64)
    )
    return np.bincount(joint, minlength=num_gt * num_pred).reshape(
        num_gt, num_pred
    )


class PredsmIoU:
    """API-compatible with the reference metric: update / reset / compute.

    Capacity follows the data: the reference inferred class counts from the
    observed uniques at compute time (metrics.py:255-267); here the confusion
    matrix grows whenever an update carries an id beyond the current
    capacity (rounded up to the next power of two to bound reallocations),
    so k>capacity clusterings (e.g. CBFE's k=300 overclustering) can never
    silently alias into the wrong row.
    """

    def __init__(self, num_pred_classes: int, num_gt_classes: int, involve_bg: bool = False):
        self.involve_bg = involve_bg
        self.num_pred_classes = 0
        self.num_gt_classes = 0
        self._conf = np.zeros((0, 0), np.int64)
        # propagation-score mode keeps per-frame confusions (small)
        self._frames: list[np.ndarray] = []
        self._ensure_capacity(num_gt_classes, num_pred_classes)

    def _ensure_capacity(self, num_gt: int, num_pred: int) -> None:
        if num_gt <= self.num_gt_classes and num_pred <= self.num_pred_classes:
            return

        def grow(cur, need):
            if need <= cur:
                return cur
            cap = max(cur, 1)
            while cap < need:
                cap *= 2
            return cap

        new_gt = grow(self.num_gt_classes, num_gt) if num_gt > self.num_gt_classes else self.num_gt_classes
        new_pred = grow(self.num_pred_classes, num_pred) if num_pred > self.num_pred_classes else self.num_pred_classes
        # grow square: compute_propagation_score indexes the matrix
        # symmetrically (c[obj, obj], c[:, obj]), so a gt id beyond the pred
        # capacity (or vice versa) must widen both axes
        new_gt = new_pred = max(new_gt, new_pred)
        conf = np.zeros((new_gt, new_pred), np.int64)
        conf[: self.num_gt_classes, : self.num_pred_classes] = self._conf
        self._conf = conf
        self._frames = [
            np.pad(f, ((0, new_gt - f.shape[0]), (0, new_pred - f.shape[1])))
            for f in self._frames
        ]
        self.num_gt_classes, self.num_pred_classes = new_gt, new_pred

    def reset(self) -> None:
        self._conf[:] = 0
        self._frames = []

    def _count(self, gt, pred) -> np.ndarray | None:
        gt, pred = np.asarray(gt), np.asarray(pred)
        if gt.size == 0:
            return None
        self._ensure_capacity(int(gt.max()) + 1, int(pred.max()) + 1)
        return confusion_matrix(
            gt, pred, self.num_gt_classes, self.num_pred_classes
        )

    def update(self, gt, pred) -> None:
        c = self._count(gt, pred)
        if c is not None:
            self._conf += c

    def update_frame(self, gt, pred) -> None:
        """Per-frame accumulation for the VOS propagation score
        (reference compute_propagation_score keeps frames separate,
        metrics.py:271-346)."""
        c = self._count(gt, pred)
        if c is None:
            c = np.zeros_like(self._conf)
        self._frames.append(c)
        self._conf += c

    # ------------------------------------------------------------------ #

    def compute(
        self,
        is_global_zero: bool = True,
        many_to_one: bool = False,
        precision_based: bool = False,
        linear_probe: bool = False,
    ):
        """Returns (miou, tp, fp, fn, mapping, matched_bg_fraction).

        ``mapping`` is a dict {observed pred class → gt class} (empty for
        linear_probe where predictions are already in gt space).
        """
        if not is_global_zero:
            return None
        conf = self._conf
        gt_classes = np.flatnonzero(conf.sum(axis=1) > 0)
        pred_classes = np.flatnonzero(conf.sum(axis=0) > 0)
        if linear_probe:
            # identity mapping restricted to observed classes
            mapping = {int(p): int(p) for p in pred_classes}
            miou, tp, fp, fn = self._iou_from_mapping(conf, gt_classes, mapping)
            return miou, tp, fp, fn, mapping, 1.0 / max(len(gt_classes), 1)

        sub = conf[np.ix_(gt_classes, pred_classes)].astype(np.float64)
        row = sub.sum(axis=1, keepdims=True)   # gt totals
        col = sub.sum(axis=0, keepdims=True)   # pred totals
        if precision_based:
            score = sub / np.maximum(col, 1e-8)
        else:
            score = sub / np.maximum(row + col - sub, 1e-8)  # IoU

        if many_to_one:
            # Greedy: every observed pred class → gt class with best score
            # (reference _original_match, metrics.py:490-505).
            best_gt = np.argmax(score, axis=0)
            mapping = {
                int(pred_classes[j]): int(gt_classes[best_gt[j]])
                for j in range(len(pred_classes))
            }
            bg_matched = (
                np.sum(gt_classes[best_gt] == 0) / max(len(pred_classes), 1)
                if 0 in gt_classes
                else 0.0
            )
        else:
            ridx, cidx = linear_sum_assignment(1.0 - score.T)  # pred-major like ref
            mapping = {}
            matched_preds = set()
            for pi, gi in zip(ridx, cidx):
                mapping[int(pred_classes[pi])] = int(gt_classes[gi])
                matched_preds.add(int(pred_classes[pi]))
            for p in pred_classes:  # unmatched → background
                if int(p) not in matched_preds:
                    mapping[int(p)] = 0
            bg_matched = 1.0 / max(len(gt_classes), 1)

        miou, tp, fp, fn = self._iou_from_mapping(conf, gt_classes, mapping)
        return miou, tp, fp, fn, mapping, bg_matched

    def _iou_from_mapping(self, conf, gt_classes, mapping):
        """Per-gt-class IoU after remapping predicted classes."""
        num_pred = conf.shape[1]
        remap = np.zeros(num_pred, np.int64)
        for p, g in mapping.items():
            remap[p] = g
        # remapped confusion: columns pooled by target gt class
        pooled = np.zeros((conf.shape[0], conf.shape[0]), np.int64)
        np.add.at(pooled.T, remap, conf.T)
        tp_all = np.diag(pooled)
        fp_all = pooled.sum(axis=0) - tp_all
        fn_all = pooled.sum(axis=1) - tp_all
        jac, tp, fp, fn = {}, {}, {}, {}
        for g in gt_classes:
            tp[int(g)] = int(tp_all[g])
            fp[int(g)] = int(fp_all[g])
            fn[int(g)] = int(fn_all[g])
            jac[int(g)] = tp_all[g] / max(float(tp_all[g] + fp_all[g] + fn_all[g]), 1e-8)
        if not self.involve_bg:
            jac.pop(0, None)
            if not jac:
                jac[0] = 0.0  # all clusters were background (metrics.py:429-431)
        miou = float(np.mean(list(jac.values())))
        return miou, tp, fp, fn

    def remap(self, pred: np.ndarray, mapping: dict[int, int]) -> np.ndarray:
        """Apply a computed matching to a prediction array (the reference's
        ``reordered_preds``), for visualization."""
        lut = np.zeros(self.num_pred_classes, np.int64)
        for p, g in mapping.items():
            lut[p] = g
        return lut[pred]

    # ------------------------------------------------------------------ #

    # Inventory alias: the reference kept a second, near-duplicate
    # torchmetrics variant ``PredsmIoU_1`` (metrics.py:24-205) alongside the
    # plain-module one; a single implementation serves both names here.
    # (Assigned after the class body — see module tail.)

    def compute_propagation_score(self, is_global_zero: bool = True):
        """Per-object J with the reference's running-cumulative-per-frame
        averaging (metrics.py:271-346): for each non-background object,
        SUM over ALL frames of the *cumulative* IoU up to that frame,
        divided by the number of frames that contain the object.

        Deliberate reference quirk: the reference accumulates ``jac`` on
        every frame (metrics.py:338) but divides by ``frames_have_part``
        (metrics.py:341) — for an object absent from later frames the score
        can exceed 1 (e.g. present only in frame 0 of 10 with IoU 0.8 →
        ≈8.0). Reproduced exactly for score parity; the DAVIS-standard J is
        available via eval/vos.py."""
        if not is_global_zero:
            return None
        frames = np.stack(self._frames)             # [T, G, P]
        G = frames.shape[1]
        scores = []
        for obj in range(1, G):
            if frames[:, obj, :].sum() == 0 and frames[:, :, obj].sum() == 0:
                continue
            tp = fp = fn = 0.0
            acc, n_present = 0.0, 0
            for t in range(frames.shape[0]):
                c = frames[t]
                gt_mask_count = c[obj, :].sum()
                tp += c[obj, obj]
                fp += c[:, obj].sum() - c[obj, obj]
                fn += c[obj, :].sum() - c[obj, obj]
                if gt_mask_count > 0:
                    n_present += 1
                acc += tp / max(tp + fp + fn, 1e-8)
            if n_present > 0:
                scores.append(acc / n_present)
        return scores


PredsmIoU_1 = PredsmIoU
