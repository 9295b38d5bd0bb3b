"""The port's J&F metrics (timetuning_tpu_torch/eval/vos.py) and dilation
against the JAX package's on the same numpy-seeded masks, including full
and empty frames."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetuning_tpu.eval import vos as jvos
from timetuning_tpu.ops.morphology import dilate as jdilate
from timetuning_tpu_torch.eval import vos as tvos
from timetuning_tpu_torch.ops.morphology import dilate as tdilate

torch.set_num_threads(2)


def _masks(seed=0, n=4, h=24, w=30):
    rng = np.random.default_rng(seed)
    m = rng.random((n, h, w)) < 0.4
    m[1] = True                        # full frame
    m[2] = False                       # empty frame
    m[3] = False
    m[3, 5:15, 8:20] = True            # a box
    return m


@pytest.mark.parametrize("seed", [0, 1])
def test_boundary_map_matches_jax(seed):
    for m in _masks(seed):
        np.testing.assert_array_equal(
            tvos.boundary_map(torch.from_numpy(m)).numpy(),
            np.asarray(jvos.boundary_map(jnp.asarray(m))))


@pytest.mark.parametrize("radius", [0, 1, 3])
def test_dilate_matches_jax(radius):
    for m in _masks(2):
        np.testing.assert_array_equal(
            tdilate(torch.from_numpy(m), radius).numpy(),
            np.asarray(jdilate(jnp.asarray(m), radius)))


def test_frame_metrics_match_jax():
    """J and F on every pairing of random, full, empty and box masks."""
    a, b = _masks(3), _masks(4)
    for p in a:
        for g in b:
            pj, gj = jnp.asarray(p), jnp.asarray(g)
            pt, gt = torch.from_numpy(p), torch.from_numpy(g)
            np.testing.assert_allclose(tvos.region_iou(pt, gt).item(),
                                       float(jvos.region_iou(pj, gj)), rtol=1e-6)
            np.testing.assert_allclose(tvos.boundary_f_measure(pt, gt).item(),
                                       float(jvos.boundary_f_measure(pj, gj)),
                                       rtol=1e-6)


def test_sequence_and_j_and_f_match_jax():
    """Object ids from the full ground truth (an object absent from the
    scored slice is still scored), aggregation over sequences."""
    rng = np.random.default_rng(5)
    seqs_j, seqs_t = [], []
    for s in range(3):
        gt = rng.integers(0, 3, (5, 20, 20))
        pred = np.where(rng.random(gt.shape) < 0.8, gt, rng.integers(0, 3, gt.shape))
        ids = [1, 2, 3]
        seqs_j.append(jvos.evaluate_sequence(pred, gt, obj_ids=ids))
        seqs_t.append(tvos.evaluate_sequence(pred, gt, obj_ids=ids))
        for oid in ids:
            for key in ("J", "F"):
                np.testing.assert_allclose(seqs_t[-1][oid][key],
                                           seqs_j[-1][oid][key], rtol=1e-6)
    want, got = jvos.j_and_f(seqs_j), tvos.j_and_f(seqs_t)
    for key in ("J", "F", "J&F"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    assert tvos.evaluate_sequence(np.zeros((0, 4, 4)), np.zeros((0, 4, 4))) == {}


def test_db_statistics_matches_jax():
    x = np.random.default_rng(6).random(23)
    assert tvos.db_statistics(x) == jvos.db_statistics(x)
