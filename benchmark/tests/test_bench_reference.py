"""Each plain reference against the port's CPU path at tiny sizes (the test
ViT: D 32, 2 blocks, patch 8), and the drivers' comparisons at f32, where
the program and the reference must agree to rounding."""

from __future__ import annotations

import os
import tempfile

import numpy as np
import pytest
import torch
from conftest import TINY, tiny_run

from benchmark import generate
from benchmark.reference import augment as ref_aug
from benchmark.reference import dense as ref_dense
from benchmark.reference import propagation as ref_prop
from benchmark.reference import timet as ref_timet
from benchmark.reference import vit as ref_vit

CPU = torch.device("cpu")
SHAPE = ref_vit.ViTShape.of(TINY)


def _backbone(weights):
    from timetuning_tpu_torch.models.registry import get_backbone

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "b.pth")
        torch.save(weights, path)
        return get_backbone("vit-tiny-test", path, dtype=torch.float32, device="cpu")


def test_timet_init_is_the_programs():
    from timetuning_tpu_torch.core import train as ttrain

    cfg = ttrain.TrainingConfig(architecture="vit-tiny-test", head_dims=(64, 32),
                                num_clusters=10, input_resolution=32,
                                compute_dtype="float32", unfreeze_layers=("blocks.1",),
                                seed=2 ** 33 + 5, device="cpu")
    model = ttrain.build_model(cfg, "cpu")[0]
    mine = ref_vit.timet_init(SHAPE, (64, 32), 10, 2 ** 33 + 5)
    prog = dict(model.named_parameters())
    assert set(prog) == set(mine)
    for k, v in prog.items():
        assert torch.equal(v.detach(), mine[k]), k


def test_augment_is_the_programs():
    from timetuning_tpu_torch.core.train import step_generator
    from timetuning_tpu_torch.data import transforms as tf

    bank, _ = generate.clips(3, 4, 4, 40, 40, (2, 2), False, "gradient", CPU)
    frames = torch.from_numpy(bank)
    sizes = torch.tensor([[72, 128], [128, 72], [60, 60], [100, 300]])
    gray = torch.from_numpy(generate.pil_gray_means(bank))
    for step in range(3):
        p = tf.draw_augment_params(step_generator(3, step), 4, 4, tf.AugmentConfig(out_size=32))
        table = ref_aug.draw(ref_timet.step_generator(3, step), 4, 4)
        assert torch.equal(p.table, table)
        want, _ = tf.apply_augment(frames, p, tf.AugmentConfig(out_size=32), sizes, gray)
        got = ref_aug.augment(frames, table, sizes, gray, 32)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [32, 64])
def test_features_are_the_programs(size):
    """At 64 the stored 4 x 4 positions are resized to 8 x 8 (DINO's
    bicubic with its +0.1)."""
    from timetuning_tpu_torch.data.transforms import eval_preprocess_batch

    w = ref_vit.seeded_weights(SHAPE, 11, CPU)
    bb = _backbone(w)
    frames = torch.from_numpy(generate.clips(4, 1, 3, 48, 80, (1, 2), True, "noise", CPU)[0][0])
    x = eval_preprocess_batch(frames, out_size=size)
    want = bb.apply(x)[0]
    mine = ref_dense.preprocess(frames, size, TINY["normalize_mean"], TINY["normalize_std"])
    torch.testing.assert_close(mine, x, rtol=0, atol=2e-6)
    got = ref_dense.features(w, frames, SHAPE, size, TINY["normalize_mean"],
                             TINY["normalize_std"])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_propagation_and_sinkhorn_are_the_programs():
    from timetuning_tpu_torch.ops.propagation import propagate_labels_batch
    from timetuning_tpu_torch.ops.sinkhorn import sinkhorn_assignment

    g = torch.Generator().manual_seed(0)
    feats = torch.randn(3, 6, 36, 16, generator=g)
    seg = torch.softmax(torch.randn(3, 5, 36, generator=g), dim=1)
    for n_last, radius in ((7, 6), (4, 1), (2, 12)):
        want = propagate_labels_batch(feats, seg, n_last=n_last, radius=radius, topk=5)
        got = ref_prop.propagate(feats, seg, n_last, radius, 5)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    scores = torch.rand(50, 7, generator=g) * 2 - 1
    torch.testing.assert_close(ref_prop.sinkhorn(scores), sinkhorn_assignment(scores),
                               rtol=1e-4, atol=1e-6)


def test_train_driver_agrees_with_the_reference_at_f32():
    """The whole driver at f32 on the CPU: the program's losses, first
    gradient and change after three steps against the reference's."""
    out = tiny_run("train", seed=2 ** 31 + 3)
    n = out["numbers"]
    assert n["loss_gap"] < 1e-5 and n["grad_norm_gap"] < 1e-4 and n["change_norm_gap"] < 1e-2
    assert out["attempted"] > 0 and out["e2e"]["train_clips_per_s"] > 0


def test_data_parallel_driver_agrees_with_the_reference_at_f32():
    """Two gloo ranks of 2 clips: the program's global step against the
    reference's one-device step on the 4 clips, each rank's slice with its
    own draws."""
    out = tiny_run("train_dp", seed=2 ** 31 + 5, seconds=1.0)
    n = out["numbers"]
    assert n["loss_gap"] < 1e-5 and n["grad_norm_gap"] < 1e-4 and n["change_norm_gap"] < 1e-2
    assert out["attempted"] % 4 == 0 and out["attempted"] > 0


def test_serve_driver_agrees_with_the_reference_at_f32():
    out = tiny_run("serve", seed=2 ** 32 + 9)
    assert out["numbers"]["token_gap"] < 1e-5 and out["attempted"] > 0
