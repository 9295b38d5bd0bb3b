"""Feature clustering for unsupervised segmentation.

Counterpart of ``timetuning_tpu/eval/clustering.py`` (reference
clustering.py:20-117): PCA to 50 dims, bilinear upsampling of the reduced
patch grid to the eval resolution, then k-means fitted and assigned per
frame, per clip or over the whole set; or prototype-argmax maps. All of it
runs on the features' device (ops/kmeans.py); only the protocol's control
flow is on the host. Every k-means call draws from one generator, seeded 1
as the reference pins faiss (clustering.py:38), in the order the calls
are made.
"""

from __future__ import annotations

import numpy as np
import torch

from timetuning_tpu_torch.ops import kmeans as km
from timetuning_tpu_torch.ops.resize import patch_grid_to_image

_EPS = 1e-12

# Above this many upsampled pixels the dataset-wise path stops materialising
# the full [B F r r, pca] tensor (Pascal val at eval_res 112 is 18.2M pixels)
# and switches to the bounded path below; the JAX package's limits.
_DATASET_WISE_PIXEL_LIMIT = 4_000_000
_CHUNK_PIXELS = 2_000_000


def default_generator() -> torch.Generator:
    return torch.Generator().manual_seed(1)


def _num_classes_from_annotations(annotations) -> int:
    return int(len(np.unique(np.asarray(annotations))))


def cluster_features(features: torch.Tensor, k: int, eval_resolution: int,
                     protocol: str = "dataset-wise",
                     generator: torch.Generator | None = None,
                     annotations=None, pca_dim: int = 50, n_iter: int = 50,
                     n_redo: int = 5) -> torch.Tensor:
    """features [B, F, N, D] -> [B, F, eval_res, eval_res] int64 cluster maps
    (reference ``cluster_features``, clustering.py:20-80). With
    ``annotations``, k is their number of distinct labels (:31-32)."""
    if generator is None:
        generator = default_generator()
    if annotations is not None:
        k = _num_classes_from_annotations(annotations)
    B, F, N, D = features.shape
    res = int(round(N ** 0.5))
    pca_dim = min(pca_dim, D)
    reduced = km.normalize_and_reduce(features.reshape(B * F * N, D), pca_dim)
    grids = reduced.reshape(B * F, N, pca_dim)
    r = eval_resolution
    pts_per_frame = r * r
    n_total = B * F * pts_per_frame

    def fit_assign(x):
        return km.kmeans(x, k, generator, n_iter=n_iter, n_redo=n_redo).assignments

    if (protocol == "dataset-wise" and n_total > _DATASET_WISE_PIXEL_LIMIT
            and n_total > 256 * k):
        out = _dataset_wise_bounded(grids, generator, k, (res, res), r,
                                    n_iter, n_redo, pca_dim)
        return out.reshape(B, F, r, r)

    maps = patch_grid_to_image(grids, (res, res), (r, r))        # [BF, r, r, pca]
    if protocol == "frame-wise":
        out = torch.stack([fit_assign(maps[i].reshape(pts_per_frame, -1))
                           for i in range(B * F)])
    elif protocol == "sample-wise":
        maps_c = maps.reshape(B, F * pts_per_frame, -1)
        out = torch.stack([fit_assign(maps_c[i]) for i in range(B)])
    elif protocol == "dataset-wise":
        out = fit_assign(maps.reshape(n_total, -1))
    else:
        raise ValueError(f"unknown protocol {protocol}")
    return out.reshape(B, F, r, r)


def _dataset_wise_bounded(grids, generator, k, grid_hw, r, n_iter, n_redo,
                          pca_dim):
    """Dataset-wise k-means without materialising the full pixel set: the
    fit subset is the same draw over the virtual [B F r r] pixel array that
    ``kmeans``'s subsample would take, gathered from upsampled chunks of
    frames; the assignment runs chunk by chunk. Peak memory is one chunk of
    ~2M pixels."""
    BF = grids.shape[0]
    ppf = r * r
    n_total = BF * ppf
    draws = km.kmeans_draws(generator, n_total, k, n_redo)
    idx = draws.subsample.to(grids.device)
    cf = max(1, min(BF, _CHUNK_PIXELS // ppf))

    def chunks():
        for s in range(0, BF, cf):
            px = patch_grid_to_image(grids[s:s + cf], grid_hw, (r, r))
            yield s * ppf, px.reshape(-1, pca_dim)

    fit_x = torch.zeros(idx.shape[0], pca_dim, device=grids.device)
    for start, px in chunks():
        local = idx - start
        inb = (local >= 0) & (local < px.shape[0])
        fit_x[inb] = px[local[inb]]
    result = km.kmeans(fit_x, k, n_iter=n_iter, n_redo=n_redo,
                       draws=km.KMeansDraws(None, draws.init))
    return torch.cat([km.kmeans_assign(px, result.centroids) for _, px in chunks()])


def prototype_merge_table(prototypes: torch.Tensor, num_classes: int,
                          generator: torch.Generator | None = None) -> torch.Tensor:
    """[K] table mapping each prototype to its merged class: k-means over the
    prototypes (reference clustering.py:106-116)."""
    if generator is None:
        generator = default_generator()
    pn = prototypes / (torch.linalg.vector_norm(prototypes, dim=-1, keepdim=True) + _EPS)
    return km.kmeans(pn, num_classes, generator, n_iter=50, n_redo=5).assignments


def proto_clustering(features: torch.Tensor, prototypes: torch.Tensor,
                     eval_resolution: int, num_classes: int | None = None,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """Prototype-argmax cluster maps (reference clustering.py:85-117): cosine
    scores against the prototypes, upsampled, argmax; with ``num_classes``
    below K the prototypes are k-means-merged first (:106-116)."""
    B, F, N, D = features.shape
    res = int(round(N ** 0.5))
    fn = features / (torch.linalg.vector_norm(features, dim=-1, keepdim=True) + _EPS)
    pn = prototypes / (torch.linalg.vector_norm(prototypes, dim=-1, keepdim=True) + _EPS)
    scores = torch.einsum("bfnd,kd->bfnk", fn.float(), pn.float())
    maps = patch_grid_to_image(scores.reshape(B * F, N, -1), (res, res),
                               (eval_resolution, eval_resolution))
    assign = maps.argmax(dim=-1)
    if num_classes is not None and num_classes < prototypes.shape[0]:
        assign = prototype_merge_table(prototypes, num_classes, generator)[assign]
    return assign.reshape(B, F, eval_resolution, eval_resolution)
