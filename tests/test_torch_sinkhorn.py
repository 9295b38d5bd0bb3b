"""The port's Sinkhorn (timetuning_tpu_torch/ops/sinkhorn.py, the
diagonal-scaling form and kernel 11's plain version, and ops/sinkhorn_cuda.py's
``sinkhorn_plain``, the TPU kernel's materialising loop) against the JAX package's on the same numpy-seeded inputs:
``ops.sinkhorn.sinkhorn``, the numpy oracle, and the TPU kernel
``sinkhorn_pallas`` in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.reference_numpy import sinkhorn_np
from timetuning_tpu.ops.sinkhorn import sinkhorn as jsinkhorn
from timetuning_tpu.ops.sinkhorn import sinkhorn_assignment as jassign
from timetuning_tpu.ops.sinkhorn_pallas import sinkhorn_pallas
from timetuning_tpu_torch.ops.sinkhorn import sinkhorn, sinkhorn_assignment
from timetuning_tpu_torch.ops.sinkhorn_cuda import sinkhorn_cuda, sinkhorn_plain

torch.set_num_threads(2)

# f32 sums taken in another order: a few ulps on values of order 1/K
RTOL = 1e-5


def _scores(B, K, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, size=(B, K)).astype(np.float32)


def _Q(B, K, seed, eps=0.05):
    return np.exp(_scores(B, K, seed) / eps).T.astype(np.float32)


def _valid(B, seed):
    v = (np.random.default_rng(seed).uniform(size=B) > 0.3).astype(np.float32)
    v[0] = 1.0
    return v


@pytest.mark.parametrize("K,B,n_iters", [(8, 50, 3), (20, 300, 10), (200, 392, 10)])
def test_matvec_form_matches_jax_and_numpy(K, B, n_iters):
    Q = _Q(B, K, seed=K + B)
    got = sinkhorn(torch.from_numpy(Q), n_iters).numpy()
    want = np.asarray(jsinkhorn(jnp.asarray(Q), n_iters))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-9)
    # the f64 oracle: f32 rounding of exp(20)-sized dynamic range
    np.testing.assert_allclose(got, sinkhorn_np(Q, n_iters), rtol=2e-4, atol=1e-8)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)


def test_matvec_form_with_valid_mask_and_world_size():
    K, B = 12, 90
    Q, valid = _Q(B, K, seed=3), _valid(B, seed=4)
    got = sinkhorn(torch.from_numpy(Q), 10, valid=torch.from_numpy(valid)).numpy()
    want = np.asarray(jsinkhorn(jnp.asarray(Q), 10, valid=jnp.asarray(valid)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-9)
    assert np.all(got[valid == 0] == 0)
    got2 = sinkhorn(torch.from_numpy(Q), 5, world_size=4).numpy()
    want2 = np.asarray(jsinkhorn(jnp.asarray(Q), 5, world_size=4))
    np.testing.assert_allclose(got2, want2, rtol=RTOL, atol=1e-9)


def test_matvec_form_pins_an_underflowed_prototype_row():
    """A prototype whose scores underflow exp(s / eps) to exactly 0 is an
    all-zero row of Q: pinned, finite, and equal to JAX."""
    K, B = 8, 40
    s = _scores(B, K, seed=5)
    s[:, 2] = -100.0                      # exp(-100 / 0.05) == 0 in f32
    got = sinkhorn_assignment(torch.from_numpy(s)).numpy()
    want = np.asarray(jassign(jnp.asarray(s)))
    assert np.isfinite(got).all() and np.all(got[:, 2] == 0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-9)


def test_assignment_carries_no_gradient():
    s = torch.from_numpy(_scores(30, 6, seed=6)).requires_grad_(True)
    assert not sinkhorn_assignment(s).requires_grad


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("K,B,n_iters", [(8, 50, 3), (200, 300, 10)])
def test_plain_matches_tpu_kernel_in_interpret_mode(K, B, n_iters, with_valid):
    """f32, 1e-6 relative (plus an absolute floor one ulp of 1/K wide)."""
    Q = _Q(B, K, seed=K * B)
    valid = _valid(B, seed=7) if with_valid else None
    got = sinkhorn_plain(torch.from_numpy(Q), n_iters,
                         None if valid is None else torch.from_numpy(valid)).numpy()
    want = np.asarray(sinkhorn_pallas(
        jnp.asarray(Q), n_iters,
        valid=None if valid is None else jnp.asarray(valid), interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_materialising_and_matvec_forms_agree_without_underflow():
    Q = _Q(120, 10, seed=8)
    a = sinkhorn_plain(torch.from_numpy(Q), 10).numpy()
    b = sinkhorn(torch.from_numpy(Q), 10).numpy()
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-9)


def test_kernel_wrapper_takes_plain_version_on_cpu_and_refuses_grad():
    """Kernel 11 computes the matvec form with no process group: that is
    its plain version on CPU tensors."""
    Q = torch.from_numpy(_Q(40, 8, seed=9))
    assert torch.equal(sinkhorn_cuda(Q, 3), sinkhorn(Q, 3))
    with pytest.raises(RuntimeError, match="no backward"):
        sinkhorn_cuda(Q.clone().requires_grad_(True), 3)
    with torch.no_grad():
        sinkhorn_cuda(Q.clone().requires_grad_(True), 3)
