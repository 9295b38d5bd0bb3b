"""Cluster-Based Foreground Extraction (CBFE).

Counterpart of ``timetuning_tpu/eval/cbfe.py`` (reference
cluster_based_foreground_extraction.py): overcluster PCA-50 features (k = 300)
at resolution 100, score each cluster's precision against the pseudo
foreground of the ViT's attention (:85-107), tune a precision threshold on a
labelled train split by sweeping the 55-75 % background-cluster range for
the best Jaccard (:140-153, :208-218), then build foreground masks for the
val split (:198-227) and report boundary F and Jaccard.

PCA, k-means, the per-cluster counts and the masks run on the features'
device; the threshold sweep reads [K] vectors on the host. The k-means
draws come from a ``torch.Generator`` seeded 1 for each split, as the JAX
package's ``PRNGKey(1)`` (tests hand the port JAX's draws).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from timetuning_tpu_torch.eval.bfscore import evaluate_bf_score
from timetuning_tpu_torch.eval.clustering import cluster_features
from timetuning_tpu_torch.ops.resize import resize_nearest


@dataclasses.dataclass
class CBFEConfig:
    num_clusters: int = 300
    resolution: int = 100
    pca_dim: int = 50
    sweep_lo: float = 0.55
    sweep_hi: float = 0.75
    sweep_steps: int = 21


def overcluster(features: torch.Tensor, cfg: CBFEConfig,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """[B, F, N, D] -> cluster maps [B F, res, res] on the features' device,
    through ``eval/clustering.cluster_features`` dataset-wise, so a split at
    trainaug scale takes its bounded two-pass path."""
    maps = cluster_features(features, cfg.num_clusters, cfg.resolution,
                            protocol="dataset-wise",
                            generator=generator,
                            pca_dim=cfg.pca_dim)
    B, F = maps.shape[:2]
    return maps.reshape(B * F, cfg.resolution, cfg.resolution)


def cluster_precisions(assignments: torch.Tensor, attn_fg: torch.Tensor,
                       num_clusters: int) -> torch.Tensor:
    """Per-cluster precision against the attention's pseudo foreground
    (reference ``get_cluster_precs``, :85-107): [M, r, r] cluster ids and
    [M, r, r] binary masks -> [K] f32."""
    a = assignments.reshape(-1)
    fg = attn_fg.reshape(-1).float()
    counts = torch.bincount(a, minlength=num_clusters).float()
    hits = torch.bincount(a, weights=fg, minlength=num_clusters).float()
    return hits / counts.clamp(min=1.0)


def masks_from_threshold(assignments: torch.Tensor, precisions: torch.Tensor,
                         threshold: float) -> torch.Tensor:
    """Foreground = the pixels whose cluster's precision >= threshold."""
    return (precisions >= threshold)[assignments]


def _jaccard(pred: np.ndarray, gt: np.ndarray) -> float:
    inter = np.logical_and(pred, gt).sum()
    union = np.logical_or(pred, gt).sum()
    return float(inter) / max(float(union), 1.0)


def find_good_threshold(assignments, precisions, gt_fg,
                        cfg: CBFEConfig) -> tuple[float, float]:
    """Sweep the thresholds that span the 55-75 % background-cluster range,
    keep the best train Jaccard, round it to 0.05 (reference :140-153,
    :208-218). Each candidate's Jaccard follows from per-cluster counts (one
    bincount of pixels and one of ground-truth hits, on the device, summed on
    the host in f64): inter(t) = sum of the hits of clusters with precision
    >= t, union(t) = pred(t) + |gt| - inter(t). The reference's quirk is
    kept: its Jaccard calls pass with_boundary=True (:149, :194), so Pascal's
    255 void band counts as ground-truth foreground."""
    precs = torch.as_tensor(precisions).cpu().numpy()
    order = np.sort(precs)
    a = torch.as_tensor(assignments).reshape(-1)
    g = torch.as_tensor(gt_fg, device=a.device).reshape(-1).float()
    K = cfg.num_clusters
    counts = torch.bincount(a, minlength=K).cpu().numpy().astype(np.float64)
    gt_hits = torch.bincount(a, weights=g, minlength=K).cpu().numpy().astype(np.float64)
    gt_total = float(gt_hits.sum())
    results = []
    for frac in np.linspace(cfg.sweep_lo, cfg.sweep_hi, cfg.sweep_steps):
        th = float(order[min(int(frac * len(order)), len(order) - 1)])
        fg_c = precs >= th
        inter = gt_hits[fg_c].sum()
        pred = counts[fg_c].sum()
        union = pred + gt_total - inter
        results.append((th, inter / max(union, 1.0)))
    best_th, best_j = max(results, key=lambda t: t[1])
    return round(best_th * 20) / 20, best_j


class ClusterBasedForegroundExtraction:
    """The whole CBFE (reference class at :156-279).

    ``feature_fn(frames) -> (features [B, F, N, D], attn_fg [B F, r, r])``:
    features without a head and the processed attention masks at the
    feature grid, which are upsampled here to ``cfg.resolution``."""

    def __init__(self, feature_fn, cfg: CBFEConfig | None = None):
        self.feature_fn = feature_fn
        self.cfg = cfg or CBFEConfig()

    def _collect(self, loader):
        feats, attns, gts = [], [], []
        for batch in loader:
            f, a = self.feature_fn(batch[0])
            feats.append(f)
            attns.append(a)
            gts.append(np.asarray(batch[1]))
        return torch.cat(feats), torch.cat(attns), np.concatenate(gts)

    def _up(self, x: torch.Tensor) -> torch.Tensor:
        r = self.cfg.resolution
        return resize_nearest(x.float(), (r, r))

    def _gt_fg(self, gt: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        return self._up(torch.from_numpy((gt > 0).astype(np.float32))).reshape(
            like.shape) > 0.5

    def get_foreground_masks(self, train_loader, val_loader) -> dict:
        cfg = self.cfg
        feats_tr, attn_tr, gt_tr = self._collect(train_loader)
        assign_tr = overcluster(feats_tr, cfg)
        del feats_tr                 # the split's raw features
        precs = cluster_precisions(assign_tr, self._up(attn_tr) > 0.5, cfg.num_clusters)
        threshold, train_j = find_good_threshold(
            assign_tr, precs, self._gt_fg(gt_tr, assign_tr).to(assign_tr.device), cfg)

        feats_va, attn_va, gt_va = self._collect(val_loader)
        assign_va = overcluster(feats_va, cfg)
        del feats_va
        precs_va = cluster_precisions(assign_va, self._up(attn_va) > 0.5,
                                      cfg.num_clusters)
        masks_va = masks_from_threshold(assign_va, precs_va, threshold)
        gt_fg_va = self._gt_fg(gt_va, masks_va).to(masks_va.device)
        return {
            "threshold": threshold,
            "train_jaccard": train_j,
            "val_jaccard": _jaccard(masks_va.cpu().numpy(), gt_fg_va.cpu().numpy()),
            "val_bf": evaluate_bf_score(gt_fg_va, masks_va),
            "fg_masks": masks_va.cpu().numpy(),
        }
