"""The port's label propagation (timetuning_tpu_torch/ops/propagation.py and
the CPU path of ops/propagation_cuda.py) against the JAX package's XLA path
and its Pallas kernel in interpret mode, on the same numpy-seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetuning_tpu.ops import propagation as jprop
from timetuning_tpu.ops.propagation_pallas import propagate_labels_batch_pallas
from timetuning_tpu_torch.ops import propagation as tprop
from timetuning_tpu_torch.ops import propagation_cuda as tprop_cuda

torch.set_num_threads(2)


def _inputs(B=2, T=4, N=16, D=24, K=6, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T, N, D)).astype(np.float32)
    logits = rng.standard_normal((B, K, N)).astype(np.float32)
    seg = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    return feats, seg.astype(np.float32)


def _both(feats, seg, **kw):
    want = jprop.propagate_labels_batch(jnp.asarray(feats), jnp.asarray(seg), **kw)
    got = tprop.propagate_labels_batch(torch.from_numpy(feats),
                                       torch.from_numpy(seg), **kw)
    return got.numpy(), np.asarray(want)


CASES = [(7, 1, 5), (1, 2, 3), (2, 0, 5)]


@pytest.mark.parametrize("n_last,radius,topk", CASES)
def test_matches_jax_xla(n_last, radius, topk):
    got, want = _both(*_inputs(), n_last=n_last, radius=radius, topk=topk)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_last,radius,topk", CASES)
def test_matches_pallas_kernel_interpret(n_last, radius, topk):
    feats, seg = _inputs(seed=1)
    want = propagate_labels_batch_pallas(
        jnp.asarray(feats), jnp.asarray(seg), n_last=n_last, radius=radius,
        topk=topk, interpret=True)
    got = tprop_cuda.propagate_labels_batch_cuda(
        torch.from_numpy(feats), torch.from_numpy(seg), n_last=n_last,
        radius=radius, topk=topk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("T,n_last", [(3, 4), (7, 2), (25, 4)])
def test_clip_lengths_and_context_wraparound(T, n_last):
    """T=3 (one rolling slot), T=7 with 2 slots (the FIFO wraps around
    twice) and T=25, the eval clip length the kernel now serves."""
    feats, seg = _inputs(B=2, T=T, N=16, D=8, K=4, seed=T)
    got, want = _both(feats, seg, n_last=n_last, radius=1, topk=4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_t25_matches_pallas_kernel_interpret():
    feats, seg = _inputs(B=1, T=25, N=16, D=8, K=4, seed=25)
    want = propagate_labels_batch_pallas(
        jnp.asarray(feats), jnp.asarray(seg), n_last=4, radius=12, topk=5,
        interpret=True)
    got = tprop.propagate_labels_batch(torch.from_numpy(feats),
                                       torch.from_numpy(seg), n_last=4,
                                       radius=12, topk=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_nonsquare_grid_and_padding_sizes():
    """N=49 (7x7, not a multiple of the TPU kernel's 128 lanes) and an
    explicit non-square 4x8 grid."""
    got, want = _both(*_inputs(B=1, T=3, N=49, D=16, K=5, seed=3),
                      n_last=3, radius=2, topk=5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    got, want = _both(*_inputs(B=1, T=4, N=32, D=16, K=3, seed=4),
                      n_last=2, radius=1, topk=3, spatial_size=(4, 8))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_tied_affinities():
    """Repeated feature vectors give exactly tied affinities: the k-th
    largest counts duplicates and every tie at the threshold is kept."""
    feats, seg = _inputs(B=1, T=5, N=16, D=8, K=3, seed=5)
    feats[:, :, 8:] = feats[:, :, :8]            # every key has a twin
    feats[:, 3] = feats[:, 1]                    # and a frame repeats
    got, want = _both(feats, seg, n_last=3, radius=0, topk=3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_kth_largest_value_counts_duplicates():
    x = np.array([[5., 5., 5., 1., 0.], [3., 2., 2., 2., 1.],
                  [1., 0., 0., 0., 0.], [4., 4., 3., 3., 3.]], np.float32)
    for k in (1, 2, 3, 4, 5):
        want = np.asarray(jprop.kth_largest_value(jnp.asarray(x), k))
        got = tprop.kth_largest_value(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, torch.topk(torch.from_numpy(x), k).values[:, -1].numpy())


@pytest.mark.parametrize("h,w,radius", [(4, 4, 1), (3, 5, 2), (7, 7, 0)])
def test_neighborhood_mask_and_slots_match_jax(h, w, radius):
    np.testing.assert_array_equal(
        tprop.neighborhood_mask(h, w, radius).numpy(),
        np.asarray(jprop.neighborhood_mask(h, w, radius)))
    for T in range(2, 9):
        for n_last in (1, 2, 4, 7):
            assert tprop.context_slots(T, n_last) == jprop.context_slots(T, n_last)


def test_bf16_features_match_jax_at_bf16_rounding():
    feats, seg = _inputs(seed=6)
    want = jprop.propagate_labels_batch(jnp.asarray(feats, jnp.bfloat16),
                                        jnp.asarray(seg), n_last=2, radius=1,
                                        topk=5)
    got = tprop.propagate_labels_batch(torch.from_numpy(feats).to(torch.bfloat16),
                                       torch.from_numpy(seg), n_last=2,
                                       radius=1, topk=5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """A non-CPU tensor never reaches the plain version (meta tensors stand
    in for a device here)."""
    for D, match in ((24, "D % 32"), (32, "CUDA")):
        feats, seg = _inputs(D=D)
        with pytest.raises(ValueError, match=match):
            tprop_cuda.propagate_labels_batch_cuda(
                torch.from_numpy(feats).to("meta"),
                torch.from_numpy(seg).to("meta"))
