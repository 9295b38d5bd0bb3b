"""counts.py against hand counts. XLA's cost analysis on the JAX package
(the root bench scripts) counted 9.48 GF a frame for dense S/16 at 224,
323.54 GF a frame for S/8 at 448 and 47.61 GF a clip for the TimeT step at
128 clips; it counts some elementwise work and the student's repeated
forward, which these counts leave out."""

from __future__ import annotations

import pytest

from benchmark import counts

XLA_GF = {"s16_224": 9.48, "s8_448": 323.54, "step_clip": 47.61}


def test_vit_s16_224():
    # 196 patches + CLS, D 384, MLP 1,536: qkv, scores and values, proj, MLP
    t, d, h = 197, 384, 1536
    block = 2 * t * d * 3 * d + 2 * 2 * t * t * d + 2 * t * d * d + 2 * 2 * t * d * h
    hand = 12 * block + 2 * 196 * (3 * 16 * 16) * d
    gf = counts.vit_flops(224, 16, 384, 12, 1536) / 1e9
    assert gf == pytest.approx(hand / 1e9, rel=1e-12)
    assert gf == pytest.approx(9.2, rel=0.01)
    assert gf < XLA_GF["s16_224"]


def test_vit_s8_448():
    # 3,137 tokens: qkv 2.775, attention 15.11, proj 0.925, MLP 7.40 GF a block
    t, d, h = 3137, 384, 1536
    block = 2 * t * d * 3 * d + 4 * t * t * d + 2 * t * d * d + 4 * t * d * h
    gf = counts.vit_flops(448, 8, 384, 12, 1536) / 1e9
    assert gf == pytest.approx((12 * block + 2 * 3136 * 192 * 384) / 1e9, rel=1e-12)
    assert gf == pytest.approx(315, rel=0.01)
    assert gf < XLA_GF["s8_448"]


def test_train_step_per_clip():
    B = 128
    total = counts.train_step_flops(B, 4, 224, 16, 384, 12, 1536, (1024, 1024, 512, 256),
                                    2, 200, 7, 6, 5)
    per_clip = total / B / 1e9
    frame = counts.vit_flops(224, 16, 384, 12, 1536) / 1e9
    tail = 2 * counts.block_flops(197, 384, 1536) / 1e9
    head = counts.head_flops(196, (384, 1024, 1024, 512, 256)) / 1e9
    # four frames, the teacher's tail and head, the student's head, the
    # backward of tail and head, scores and propagation (under 0.2 GF)
    want = 4 * frame + tail + 2 * head + 2 * (tail + head)
    assert per_clip == pytest.approx(want, abs=0.2)
    assert 44 < per_clip < XLA_GF["step_clip"]


def test_least_time_takes_the_larger_bound():
    assert counts.least_s(989e12, 0) == pytest.approx(1.0)
    assert counts.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.least_s(989e9, 3.35e12) == pytest.approx(1.0)


def test_propagation_count():
    # one clip, two frames, a 2 x 2 grid, radius covering it: frame 1
    # against frame 0, 4 x 4 affinities of D, then top-k x K
    f = counts.propagation_flops(1, 2, 4, 8, 3, 4, 5, 2)
    assert f == 4 * 4 * 2 * 8 + 1 * 4 * 2 * 3 * 2
