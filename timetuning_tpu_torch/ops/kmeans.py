"""k-means and PCA on the device, in place of faiss.

Counterpart of ``timetuning_tpu/ops/kmeans.py``. The reference clusters
dense features with faiss-cpu ``Kmeans(d, k, niter=50, nredo=5, seed=1)``
after a StandardScaler + ``PCAMatrix`` reduction (reference
clustering.py:38-73, my_utils.py:19-37):

  * Lloyd iterations whose assignment step is one [N, k] distance product,
    tiled over point chunks so the distance matrix never materialises for
    dataset-scale N (a plain matrix product: the JAX package computes it
    outside any Pallas kernel);
  * ``n_redo`` restarts, the one with the least objective wins (faiss);
    an empty cluster keeps its previous centroid;
  * faiss's training subsample: above 256 points a centroid, the fit runs
    on 256 k points drawn with replacement, then everything is assigned;
  * exact PCA from the covariance's eigendecomposition, after
    standardisation, also from streamed moments.

The random draws (the subsample and each restart's initial centroids) come
from ``kmeans_draws`` on the host, from a ``torch.Generator``, and are
handed to the fit, so the fit itself is deterministic given them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_EPS = 1e-12


class KMeansResult(NamedTuple):
    centroids: torch.Tensor    # [k, D]
    assignments: torch.Tensor  # [N] int64
    objective: torch.Tensor    # scalar: the sum of squared distances


class KMeansDraws(NamedTuple):
    subsample: torch.Tensor | None   # [256 k] point indices, or None
    init: torch.Tensor               # [n_redo, k] indices into the fit set


def kmeans_draws(generator: torch.Generator | None, n: int, k: int,
                 n_redo: int = 5,
                 max_points_per_centroid: int | None = 256) -> KMeansDraws:
    """The random values of one ``kmeans`` call over ``n`` points: the
    faiss subsample (with replacement) when ``n`` exceeds its cap, then for
    each restart ``k`` distinct initial points of the fit set."""
    cap = n if max_points_per_centroid is None else k * max_points_per_centroid
    sub = None
    if n > cap:
        sub = torch.randint(0, n, (cap,), generator=generator)
        n = cap
    init = torch.stack([torch.randperm(n, generator=generator)[:k]
                        for _ in range(n_redo)])
    return KMeansDraws(sub, init)


def _assign_chunked(x, centroids, chunk: int):
    """(argmin over centroids, min squared distance) of each row of x,
    ``chunk`` rows at a time."""
    c_sq = (centroids ** 2).sum(dim=1)
    a = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    dmin = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], chunk):
        xc = x[s:s + chunk]
        d = ((xc ** 2).sum(dim=1, keepdim=True)
             - 2.0 * torch.matmul(xc, centroids.t()) + c_sq[None, :])
        dmin[s:s + chunk], a[s:s + chunk] = d.min(dim=1)
    return a, dmin


def _lloyd(x, centroids, n_iter: int, chunk: int):
    k, D = centroids.shape
    for _ in range(n_iter):
        a, _ = _assign_chunked(x, centroids, chunk)
        sums = torch.zeros(k, D, dtype=x.dtype, device=x.device).index_add_(0, a, x)
        counts = torch.bincount(a, minlength=k).to(x.dtype)[:, None]
        new_c = sums / torch.clamp(counts, min=1.0)
        centroids = torch.where(counts > 0, new_c, centroids)
    a, dmin = _assign_chunked(x, centroids, chunk)
    return centroids, a, dmin.sum()


def kmeans(x: torch.Tensor, k: int, generator: torch.Generator | None = None,
           n_iter: int = 50, n_redo: int = 5, chunk: int = 8192,
           max_points_per_centroid: int | None = 256,
           draws: KMeansDraws | None = None) -> KMeansResult:
    """Lloyd k-means with restarts on x's device. x: [N, D] float.
    ``draws`` (default: ``kmeans_draws`` from ``generator``) fix the
    subsample and the initial centroids; the rest is deterministic up to the
    order of the centroid sums on the card."""
    x = x.float()
    N = x.shape[0]
    if draws is None:
        draws = kmeans_draws(generator, N, k, n_redo, max_points_per_centroid)
    fit_x = x if draws.subsample is None else x[draws.subsample.to(x.device)]
    best_c = torch.zeros(k, x.shape[1], dtype=torch.float32, device=x.device)
    best_obj = torch.tensor(float("inf"), device=x.device)
    for idx in draws.init.to(x.device):
        c, _, obj = _lloyd(fit_x, fit_x[idx], n_iter, chunk)
        better = obj < best_obj
        best_c = torch.where(better, c, best_c)
        best_obj = torch.minimum(obj, best_obj)
    a, dmin = _assign_chunked(x, best_c, chunk)
    return KMeansResult(best_c, a, dmin.sum())


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor,
                  chunk: int = 8192) -> torch.Tensor:
    """Nearest-centroid assignment of points outside the fit (faiss
    ``index.search`` after ``Kmeans.train``). x: [N, D]."""
    a, _ = _assign_chunked(x.float(), centroids.float(), chunk)
    return a


class PCAState(NamedTuple):
    mean: torch.Tensor        # [D]
    std: torch.Tensor         # [D]
    components: torch.Tensor  # [D, d_out]


class PCAMoments(NamedTuple):
    """Streamed statistics for standardise + PCA: count, sum x, sum x x^T,
    accumulated on the host in float64 (the reference's chunked
    ``StandardScaler.partial_fit``, my_utils.py:19-37)."""

    count: float
    s1: np.ndarray   # [D] float64
    s2: np.ndarray   # [D, D] float64


def init_moments(d: int) -> PCAMoments:
    return PCAMoments(0.0, np.zeros(d, np.float64), np.zeros((d, d), np.float64))


def update_moments(m: PCAMoments, x: torch.Tensor) -> PCAMoments:
    """Fold a [N, D] batch in: f32 sums on its device, float64 on the host."""
    x = x.float()
    s1 = x.sum(dim=0).cpu().numpy().astype(np.float64)
    s2 = torch.matmul(x.t(), x).cpu().numpy().astype(np.float64)
    return PCAMoments(m.count + float(x.shape[0]), m.s1 + s1, m.s2 + s2)


def _top_components(cov: torch.Tensor, d_out: int) -> torch.Tensor:
    _, evecs = torch.linalg.eigh(cov)             # ascending eigenvalues
    return evecs.flip(-1)[:, :d_out]


def pca_from_moments(m: PCAMoments, d_out: int, standardize: bool = True,
                     device: torch.device | str = "cpu") -> PCAState:
    """``fit_pca`` from streamed moments: cov(x_hat) = (E[x x^T] - mu mu^T)
    / ((sigma + eps)(sigma + eps)^T)."""
    mean = m.s1 / m.count
    cov_raw = m.s2 / m.count - np.outer(mean, mean)
    std = (np.sqrt(np.maximum(np.diag(cov_raw), 0.0)) if standardize
           else np.ones_like(mean))
    cov = (cov_raw / np.outer(std + _EPS, std + _EPS)).astype(np.float32)
    comps = _top_components(torch.from_numpy(cov).to(device), d_out)
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    return PCAState(as_t(mean), as_t(std), comps)


def fit_pca(x: torch.Tensor, d_out: int, standardize: bool = True) -> PCAState:
    """Standardise + exact PCA by the covariance's eigendecomposition
    (reference StandardScaler + faiss PCAMatrix, my_utils.py:19-37).
    Eigenvectors are defined up to sign: a flipped component flips that
    coordinate for every point, which changes no distance."""
    x = x.float()
    mean = x.mean(dim=0)
    std = x.std(dim=0, unbiased=False) if standardize else torch.ones_like(mean)
    xs = (x - mean) / (std + _EPS)
    cov = torch.matmul(xs.t(), xs) / x.shape[0]
    return PCAState(mean, std, _top_components(cov, d_out))


def apply_pca(state: PCAState, x: torch.Tensor) -> torch.Tensor:
    xs = (x.float() - state.mean) / (state.std + _EPS)
    return torch.matmul(xs, state.components)


def normalize_and_reduce(x: torch.Tensor, d_out: int = 50) -> torch.Tensor:
    """``normalize_and_transform`` (my_utils.py:19-37): standardise, then
    reduce the feature dim by PCA. x: [N, D] -> [N, d_out]."""
    return apply_pca(fit_pca(x, d_out), x)

