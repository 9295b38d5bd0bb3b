"""The traffic generator: the same seed gives the same frames, another seed
other frames of the same sizes; the request order is a seeded permutation
of the bank."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import generate

CPU = torch.device("cpu")


def _clips(seed: int):
    return generate.clips(seed, 3, 4, 24, 40, (1, 3), True, "noise", CPU, chunk=2)


def test_same_seed_same_frames():
    a, ia = _clips(2 ** 31 + 11)
    b, ib = _clips(2 ** 31 + 11)
    assert a.dtype == np.uint8 and a.shape == (3, 4, 24, 40, 3) and ia.shape == (3, 4, 24, 40)
    assert np.array_equal(a, b) and np.array_equal(ia, ib)


def test_other_seed_other_frames_same_sizes():
    a, _ = _clips(5)
    b, _ = _clips(6)
    assert a.shape == b.shape and not np.array_equal(a, b)


def test_objects_and_gradient_background():
    f, ids = generate.clips(9, 4, 3, 32, 32, (3, 3), False, "gradient", CPU)
    # three boxes a clip (a later box may hide an earlier one)
    assert ids.max() == 3 and all(ids[c, 0].max() > 0 for c in range(4))
    g = generate.pil_gray_means(f)
    assert g.shape == (4, 3) and np.all((g >= 0) & (g <= 255))


def test_order_is_seeded_and_cycles_the_bank():
    a = generate.order(4_000_000_000, 5, 12)
    assert np.array_equal(a, generate.order(4_000_000_000, 5, 12))
    assert sorted(a[:5]) == list(range(5)) and sorted(a[5:10]) == list(range(5))
    assert not np.array_equal(a, generate.order(4_000_000_001, 5, 12))
