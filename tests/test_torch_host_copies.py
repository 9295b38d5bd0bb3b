"""Each host module that the port keeps its own copy of, pinned to its
original in the JAX package on the same inputs: the metrics, the native
bindings, the clip loader and datasets, the Pascal loader, the exporter."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from timetuning_tpu import native as jnative
from timetuning_tpu.data import datasets as jdatasets
from timetuning_tpu.data import loader as jloader
from timetuning_tpu.data import pascal as jpascal
from timetuning_tpu.eval import metrics as jmetrics
from timetuning_tpu.models import export_torch as jexport
from timetuning_tpu.models.vit import ViTConfig as JViTConfig
from timetuning_tpu.models.vit import VisionTransformer as JVisionTransformer
from timetuning_tpu_torch import native as tnative
from timetuning_tpu_torch.data import datasets as tdatasets
from timetuning_tpu_torch.data import loader as tloader
from timetuning_tpu_torch.data import pascal as tpascal
from timetuning_tpu_torch.eval import metrics as tmetrics
from timetuning_tpu_torch.models import export_torch as texport


@pytest.mark.parametrize("matching", ["linear_probe", "hungarian", "many_to_one"])
def test_predsmiou_scores_match(matching):
    rng = np.random.default_rng(0)
    n_gt, n_pred = 4, 6 if matching == "many_to_one" else 4
    results = []
    for mod in (jmetrics, tmetrics):
        metric = mod.PredsmIoU(n_pred, n_gt, involve_bg=True)
        r = np.random.default_rng(1)
        for _ in range(3):
            gt = r.integers(0, n_gt, (2, 16, 16))
            pred = (gt + (r.uniform(size=gt.shape) < 0.3) * r.integers(0, n_pred, gt.shape)) % n_pred
            metric.update(gt, pred)
        kw = {} if matching == "linear_probe" else dict(
            linear_probe=False, many_to_one=matching == "many_to_one")
        results.append(metric.compute(is_global_zero=True, **kw))
    a, b = results
    assert a[0] == b[0] and len(a) == len(b)
    del rng


@pytest.mark.parametrize("shape", [(5, 5), (4, 7), (8, 3)])
def test_hungarian_matches(shape):
    cost = np.random.default_rng(shape[0]).uniform(size=shape)
    for a, b in zip(jnative.hungarian(cost), tnative.hungarian(cost)):
        np.testing.assert_array_equal(a, b)
    assert tnative._NATIVE_DIR == jnative._NATIVE_DIR


def test_clip_pack_round_trip_matches(tmp_path):
    frames = np.random.default_rng(2).integers(0, 256, (6, 8, 8, 3), dtype=np.uint8)
    paths = [str(tmp_path / f"{n}.pack") for n in "jt"]
    jnative.write_clip_pack(paths[0], frames)
    tnative.write_clip_pack(paths[1], frames)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    idx = np.asarray([0, 2, 5, 1, 1, 4], np.int64)
    a = jnative.ClipPack(paths[0]).gather(idx)
    b = tnative.ClipPack(paths[1]).gather(idx)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(b, frames[idx])


@pytest.fixture(scope="module")
def davis_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("davis_copies")
    for v in range(3):
        fdir = root / "JPEGImages" / "480p" / f"video{v}"
        adir = root / "Annotations" / "480p" / f"video{v}"
        fdir.mkdir(parents=True)
        adir.mkdir(parents=True)
        for f in range(6):
            img = np.full((48, 64, 3), 30 + 10 * v, np.uint8)
            img[8 + f:24 + f, 20:44] = [220, 40, 40]
            cv2.imwrite(str(fdir / f"{f:05d}.jpg"), img)
            ann = np.zeros((48, 64), np.uint8)
            ann[8 + f:24 + f, 20:44] = 1 + v % 2
            cv2.imwrite(str(adir / f"{f:05d}.png"), ann)
    return str(root)


@pytest.mark.parametrize("mode", ["UNIFORM", "DENSE"])
def test_loader_batches_match(davis_tree, mode):
    batches = []
    for mod, ds in ((jloader, jdatasets), (tloader, tdatasets)):
        loader = mod.make_loader(
            "davis_val", num_clip_frames=4, batch_size=1,
            sampling_mode=ds.SamplingMode[mode], shuffle=False, num_workers=2,
            root=davis_tree, drop_last=False)
        batches.append(list(loader))
    assert len(batches[0]) == len(batches[1]) == 3
    for a, b in zip(*batches):
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        np.testing.assert_array_equal(a.orig_sizes, b.orig_sizes)
    assert tloader.sampling_mode(mode) is tdatasets.SamplingMode[mode]
    assert [m.name for m in tdatasets.SamplingMode] == [m.name for m in jdatasets.SamplingMode]


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc_copies")
    for sub in ("images", "SegmentationClass", "SegmentationClassAug", "sets"):
        (root / sub).mkdir()
    names = [f"img{i}" for i in range(4)]
    for i, n in enumerate(names):
        img = np.full((64, 64, 3), 40, np.uint8)
        mask = np.zeros((64, 64), np.uint8)
        img[8 + 3 * i:32 + 3 * i, 16:48] = [200, 60, 60]
        mask[8 + 3 * i:32 + 3 * i, 16:48] = 1
        cv2.imwrite(str(root / "images" / f"{n}.jpg"), img)
        for sub in ("SegmentationClass", "SegmentationClassAug"):
            cv2.imwrite(str(root / sub / f"{n}.png"), mask)
    (root / "sets" / "val.txt").write_text("\n".join(names[:2]))
    (root / "sets" / "trainaug.txt").write_text("\n".join(names[2:]))
    return str(root)


@pytest.mark.parametrize("split", ["val", "trainaug"])
def test_pascal_samples_match(voc_tree, split):
    a = list(jpascal.pascal_loader(2, voc_tree, split, 16, 32))
    b = list(tpascal.pascal_loader(2, voc_tree, split, 16, 32))
    assert len(a) == len(b) == 1
    for (ia, ma), (ib, mb) in zip(a, b):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ma, mb)


def test_exporter_keys_and_arrays_match():
    cfg = JViTConfig(patch_size=8, embed_dim=32, depth=2, num_heads=2, img_size=32)
    params = JVisionTransformer(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    a, b = jexport.vit_params_to_torch(params), texport.vit_params_to_torch(params)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    head = {"lin0": {"kernel": np.ones((3, 4), np.float32), "bias": np.zeros(4, np.float32)}}
    full = {"feature_extractor": {"backbone": params, "head": head},
            "prototypes": np.ones((2, 4), np.float32)}
    fa, fb = jexport.timet_state_dict(full), texport.timet_state_dict(full)
    assert list(fa) == list(fb) and texport.exportable(full) == jexport.exportable(full)
