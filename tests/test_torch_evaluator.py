"""The port's Evaluator (eval/evaluator.py) against the JAX package's on the
same batches and the same feature function, under every protocol: the
dataset-wise one in memory and streaming, frame-wise, sample-wise,
many-to-one, prototype clustering. k-means draws come from the JAX key
(mirrored, tests/test_torch_kmeans.py); the features are three well
separated kinds laid on whole patches, with noise, and keep all their dims
through the PCA, so the clustering decides no point within rounding. Scores
equal to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kmeans import mirror_keys
from timetuning_tpu.eval import evaluator as jev
from timetuning_tpu_torch.eval import evaluator as tev

P, D = 8, 12
PROJ = np.random.default_rng(99).standard_normal((P * P * 3, D)).astype(np.float32) / 24.0


def _images(n, seed):
    """[n, 32, 32, 3] uint8 images of a red and a green box on whole 8 x 8
    patches over gray, with pixel noise; masks 1 and 2 on the boxes, a few
    pixels 255 (ignored)."""
    rng = np.random.default_rng(seed)
    img = np.full((n, 32, 32, 3), 110, np.float32)
    mask = np.zeros((n, 32, 32), np.uint8)
    for i in range(n):
        y, x = 8 * rng.integers(0, 2), 8 * rng.integers(0, 2)
        img[i, y:y + 16, x:x + 8] = [210, 40, 40]
        mask[i, y:y + 16, x:x + 8] = 1
        img[i, 24:32, 16:32] = [40, 200, 60]
        mask[i, 24:32, 16:32] = 2
        mask[i, 0, :3] = 255
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), mask


def _feats_np(frames):
    """Patch pixels projected to D dims: [n, 32, 32, 3] -> [n, 16, D]."""
    f = np.asarray(frames, np.float32) / 255.0
    n = f.shape[0]
    patches = f.reshape(n, 4, P, 4, P, 3).transpose(0, 1, 3, 2, 4, 5).reshape(n, 16, -1)
    return patches @ PROJ


def _jfn(frames, want_attention=False):
    return jnp.asarray(_feats_np(frames)), None


def _tfn(frames, want_attention=False):
    return torch.from_numpy(_feats_np(frames.numpy())), None


@pytest.fixture(scope="module")
def image_batches():
    return [_images(3, seed) for seed in (0, 1)]


@pytest.fixture(scope="module")
def clip_batches():
    out = []
    for seed in (2, 3):
        img, mask = _images(4, seed)
        out.append((img.reshape(2, 2, 32, 32, 3), mask.reshape(2, 2, 32, 32)))
    return out


def _both(batches, **kw):
    j = jev.Evaluator(lambda: iter(batches), _jfn, 4, **kw)
    t = tev.Evaluator(lambda: iter(batches), _tfn, 4, **kw)
    return j, t


CASES = {
    # name: (batches, evaluate kwargs, JAX keys of the k-means calls in order)
    "dataset-wise": ("image", dict(evaluation_protocol="dataset-wise"), "one"),
    "dataset-wise streaming": ("image", dict(evaluation_protocol="dataset-wise",
                                             streaming=True), "one"),
    "dataset-wise many-to-one": ("image", dict(evaluation_protocol="dataset-wise",
                                               many_to_one=True), "one"),
    "frame-wise": ("clip", dict(evaluation_protocol="frame-wise"), "frames"),
    "sample-wise": ("clip", dict(evaluation_protocol="sample-wise"), "clips"),
    "sample-wise annotations": ("clip", dict(evaluation_protocol="sample-wise",
                                             use_annotations=True), "clips"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_evaluator_protocols_match_jax(monkeypatch, image_batches, clip_batches, name):
    kind, kw, keys = CASES[name]
    batches = image_batches if kind == "image" else clip_batches
    j, t = _both(batches, num_classes=3)
    want = j.evaluate(eval_resolution=8, num_clusters=3, **kw)
    k1 = jax.random.PRNGKey(1)
    per_batch = {"one": [k1], "frames": list(jax.random.split(k1, 4)),
                 "clips": list(jax.random.split(k1, 2))}[keys]
    mirror_keys(monkeypatch, per_batch * len(batches))
    got = t.evaluate(eval_resolution=8, num_clusters=3, **kw)
    assert 0.3 < want <= 1.0, want                    # the boxes are found
    assert abs(got - want) <= 1e-6, (got, want)


@pytest.mark.parametrize("streaming", [False, True])
def test_evaluator_prototype_clustering(monkeypatch, image_batches, streaming):
    protos = np.random.default_rng(7).standard_normal((5, D)).astype(np.float32)
    j, t = _both(image_batches, num_classes=3, clustering_algorithm="prototypes",
                 prototypes=protos)
    kw = dict(evaluation_protocol="dataset-wise", eval_resolution=8, num_clusters=3,
              streaming=streaming)
    want = j.evaluate(**kw)
    mirror_keys(monkeypatch, [jax.random.PRNGKey(1)])
    got = t.evaluate(**kw)
    assert abs(got - want) <= 1e-6, (got, want)


def test_uvos_and_fg_masks_follow_the_reference_asymmetry(image_batches, clip_batches):
    """``uvos`` binarises annotations on the frame-/sample-wise path only;
    FG masks apply on the dataset-wise path only (no k-means draw needs
    mirroring: only which path reads which flag is checked)."""
    masks = np.ones((6, 32, 32), np.float32)
    masks[:, :16] = 0
    t = tev.Evaluator(lambda: iter(image_batches), _tfn, 4, num_classes=3,
                      fg_masks=masks)
    j = jev.Evaluator(lambda: iter(image_batches), _jfn, 4, num_classes=3,
                      fg_masks=masks)
    kw = dict(evaluation_protocol="dataset-wise", eval_resolution=8, num_clusters=3)
    assert np.isfinite(t.evaluate(**kw)) and np.isfinite(j.evaluate(**kw))
    got = tev.Evaluator(lambda: iter(clip_batches), _tfn, 4, num_classes=3,
                        uvos=True).evaluate(evaluation_protocol="sample-wise",
                                            eval_resolution=8, num_clusters=2)
    assert 0.0 < got <= 1.0


def test_evaluate_localizations_and_propagation_match():
    """The host scoring functions on the same maps (many-to-one included)."""
    from timetuning_tpu.eval.metrics import PredsmIoU as JM
    from timetuning_tpu_torch.eval.metrics import PredsmIoU as TM

    rng = np.random.default_rng(5)
    gts = rng.integers(0, 3, (2, 3, 8, 8))
    preds = (gts + (rng.uniform(size=gts.shape) < 0.2)) % 4
    for proto in ("frame-wise", "sample-wise", "dataset-wise"):
        for m2o in (False, True):
            a = jev.evaluate_localizations(JM(4, 3), gts, preds, proto, m2o)
            b = tev.evaluate_localizations(TM(4, 3), gts, preds, proto, m2o)
            assert a == b, (proto, m2o)
    assert (jev.evaluate_propagation(JM(256, 256), gts, preds)
            == tev.evaluate_propagation(TM(256, 256), gts, preds))
