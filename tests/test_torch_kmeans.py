"""The port's k-means, PCA and feature clustering (ops/kmeans.py,
eval/clustering.py) against the JAX package's on the same drawn values.

JAX draws the subsample and the initial centroids from its key; the test
mirrors the key's splits with ``jax.random`` (``jax_kmeans_draws``) and
hands the values to the port. The data are seeded blobs whose clusters lie
far apart, so no point sits within f32 rounding of two centroids and no two
restarts' objectives tie (the restart choice is a comparison of
objectives); centroids and objectives at rtol 1e-5 (the distance and the
centroid sums round in another order), assignments equal. PCA components
are compared up to each component's sign, which an eigensolver does not fix
(a sign flip moves no distance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetuning_tpu.eval import clustering as jcl
from timetuning_tpu.ops import kmeans as jkm
from timetuning_tpu_torch.eval import clustering as tcl
from timetuning_tpu_torch.ops import kmeans as tkm


def jax_kmeans_draws(key, n, k, n_redo=5, max_points_per_centroid=256):
    """The values ``timetuning_tpu.ops.kmeans.kmeans(x, k, key)`` draws."""
    cap = n if max_points_per_centroid is None else k * max_points_per_centroid
    sub = None
    if n > cap:
        key, k_sub = jax.random.split(key)
        sub = torch.from_numpy(np.asarray(jax.random.randint(k_sub, (cap,), 0, n)).astype(np.int64))
        n = cap
    init = np.stack([np.asarray(jax.random.choice(kr, n, (k,), replace=False))
                     for kr in jax.random.split(key, n_redo)])
    return tkm.KMeansDraws(sub, torch.from_numpy(init.astype(np.int64)))


def mirror_keys(monkeypatch, keys):
    """Route every ``kmeans_draws`` call of the port to JAX's draws at the
    next key of ``keys``, in call order."""
    it = iter(keys)
    monkeypatch.setattr(tkm, "kmeans_draws",
                        lambda gen, n, k, n_redo=5, cap=256: jax_kmeans_draws(next(it), n, k, n_redo, cap))


def blobs(n, k, d, seed=0, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-6, 6, (k, d))
    lab = rng.integers(0, k, n)
    return (centers[lab] + spread * rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("n", [500, 3000])            # 3000 > 256 k: subsampled
def test_kmeans_matches_jax(n):
    k = 3
    x = blobs(n, k, 6, seed=n)
    key = jax.random.PRNGKey(4)
    want = jkm.kmeans(jnp.asarray(x), k, key, n_iter=10, n_redo=3)
    got = tkm.kmeans(torch.from_numpy(x), k, n_iter=10, n_redo=3,
                     draws=jax_kmeans_draws(key, n, k, 3))
    np.testing.assert_array_equal(got.assignments.numpy(), np.asarray(want.assignments))
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.objective), float(want.objective), rtol=1e-5)
    np.testing.assert_array_equal(
        tkm.kmeans_assign(torch.from_numpy(x[:50]), got.centroids, chunk=16).numpy(),
        np.asarray(jkm.kmeans_assign(jnp.asarray(x[:50]), want.centroids, chunk=16)))


def test_kmeans_draws_from_generator():
    d = tkm.kmeans_draws(torch.Generator().manual_seed(0), 3000, 3, 5)
    assert d.subsample.shape == (768,) and d.init.shape == (5, 3)
    assert all(len(set(r.tolist())) == 3 for r in d.init)
    assert tkm.kmeans_draws(None, 100, 3, 2).subsample is None


def _align(a, b):
    """Flip each column of ``a`` to the sign of ``b``'s."""
    s = np.sign((a * b).sum(axis=0))
    return a * s


def _correlated(n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 5)) @ rng.standard_normal((5, d))
            + 0.3 * rng.standard_normal((n, d)) + rng.uniform(-2, 2, d)).astype(np.float32)


def test_pca_matches_jax():
    x = _correlated(400, 8, 1)
    want = jkm.fit_pca(jnp.asarray(x), 4)
    got = tkm.fit_pca(torch.from_numpy(x), 4)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.std.numpy(), np.asarray(want.std), rtol=1e-5)
    comps = _align(got.components.numpy(), np.asarray(want.components))
    np.testing.assert_allclose(comps, np.asarray(want.components), atol=1e-4)
    red = _align(tkm.apply_pca(got, torch.from_numpy(x)).numpy(),
                 np.asarray(jkm.apply_pca(want, jnp.asarray(x))))
    np.testing.assert_allclose(red, np.asarray(jkm.apply_pca(want, jnp.asarray(x))), atol=1e-3)
    # the reduction keeps every distance when it keeps every dim
    full = tkm.normalize_and_reduce(torch.from_numpy(x), 8).numpy()
    jfull = np.asarray(jkm.normalize_and_reduce(jnp.asarray(x), 8))
    dist = lambda a: np.linalg.norm(a[:, None] - a[None], axis=-1)  # noqa: E731
    np.testing.assert_allclose(dist(full[:40]), dist(jfull[:40]), rtol=1e-4, atol=1e-4)


def test_pca_from_moments_matches_jax():
    x = _correlated(600, 8, 2)
    jm, tm = jkm.init_moments(8), tkm.init_moments(8)
    for part in np.split(x, 3):
        jm = jkm.update_moments(jm, jnp.asarray(part))
        tm = tkm.update_moments(tm, torch.from_numpy(part))
    assert jm.count == tm.count
    np.testing.assert_allclose(tm.s1, jm.s1, rtol=1e-6)
    np.testing.assert_allclose(tm.s2, jm.s2, rtol=1e-5)
    want = jkm.pca_from_moments(jm, 3)
    got = tkm.pca_from_moments(tm, 3)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-5)
    np.testing.assert_allclose(_align(got.components.numpy(), np.asarray(want.components)),
                               np.asarray(want.components), atol=1e-4)
    # the streamed fit is the in-memory one
    direct = tkm.fit_pca(torch.from_numpy(x), 3)
    np.testing.assert_allclose(_align(got.components.numpy(), direct.components.numpy()),
                               direct.components.numpy(), atol=1e-4)


def _features(B, F, seed=0):
    """[B, F, 16 patches, 12] features of three well-separated kinds laid
    out as blocks on the 4 x 4 patch grid, plus noise (full rank)."""
    rng = np.random.default_rng(seed)
    kinds = rng.uniform(-3, 3, (3, 12))
    grid = np.zeros((4, 4), int)
    grid[:2, :2] = 1
    grid[2:, 1:] = 2
    out = np.empty((B, F, 16, 12), np.float32)
    for b in range(B):
        for f in range(F):
            g = np.roll(grid, b + f, axis=1).reshape(-1)
            out[b, f] = kinds[g] + 0.2 * rng.standard_normal((16, 12))
    return out


@pytest.mark.parametrize("protocol,n_keys", [("dataset-wise", 1), ("sample-wise", 2),
                                             ("frame-wise", 6)])
def test_cluster_features_protocols(monkeypatch, protocol, n_keys):
    feats = _features(2, 3)
    key = jax.random.PRNGKey(1)
    want = jcl.cluster_features(jnp.asarray(feats), 3, 8, protocol, n_iter=8, n_redo=2)
    mirror_keys(monkeypatch, [key] if n_keys == 1 else jax.random.split(key, n_keys))
    got = tcl.cluster_features(torch.from_numpy(feats), 3, 8, protocol, n_iter=8, n_redo=2)
    assert got.shape == (2, 3, 8, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dataset_wise_bounded_path(monkeypatch):
    """The bounded path (above a pixel limit, lowered here) draws the same
    subsample over the virtual pixel array as the one-program path."""
    feats = _features(2, 3, seed=3)
    monkeypatch.setattr(jcl, "_DATASET_WISE_PIXEL_LIMIT", 100)
    monkeypatch.setattr(jcl, "_CHUNK_PIXELS", 130)
    monkeypatch.setattr(tcl, "_DATASET_WISE_PIXEL_LIMIT", 100)
    monkeypatch.setattr(tcl, "_CHUNK_PIXELS", 130)
    want = jcl.cluster_features(jnp.asarray(feats), 2, 12, "dataset-wise", n_iter=8, n_redo=2)
    mirror_keys(monkeypatch, [jax.random.PRNGKey(1)])
    got = tcl.cluster_features(torch.from_numpy(feats), 2, 12, "dataset-wise", n_iter=8, n_redo=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_proto_clustering_with_merge(monkeypatch):
    feats = _features(1, 2, seed=4)
    protos = np.random.default_rng(5).standard_normal((6, 12)).astype(np.float32)
    want = jcl.proto_clustering(jnp.asarray(feats), jnp.asarray(protos), 8, num_classes=3)
    mirror_keys(monkeypatch, [jax.random.PRNGKey(1)])
    got = tcl.proto_clustering(torch.from_numpy(feats), torch.from_numpy(protos), 8, num_classes=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = tcl.proto_clustering(torch.from_numpy(feats), torch.from_numpy(protos), 8)
    np.testing.assert_array_equal(
        plain.numpy(), np.asarray(jcl.proto_clustering(jnp.asarray(feats), jnp.asarray(protos), 8)))
