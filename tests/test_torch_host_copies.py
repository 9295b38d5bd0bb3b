"""Each host module that the port keeps its own copy of, pinned to its
original in the JAX package on the same inputs: the metrics, the native
bindings, the clip loader and datasets, the Pascal loader, the exporter,
the parity oracle."""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetuning_tpu import native as jnative
from timetuning_tpu.data import datasets as jdatasets
from timetuning_tpu.data import loader as jloader
from timetuning_tpu.data import pascal as jpascal
from timetuning_tpu.eval import metrics as jmetrics
from timetuning_tpu.eval import parity_oracle as joracle
from timetuning_tpu.models import export_torch as jexport
from timetuning_tpu.models.vit import ViTConfig as JViTConfig
from timetuning_tpu.models.vit import VisionTransformer as JVisionTransformer
from timetuning_tpu_torch import native as tnative
from timetuning_tpu_torch.data import datasets as tdatasets
from timetuning_tpu_torch.data import loader as tloader
from timetuning_tpu_torch.data import pascal as tpascal
from timetuning_tpu_torch.eval import metrics as tmetrics
from timetuning_tpu_torch.eval import parity_oracle as toracle
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


def test_metrics_writer_config_and_logger_match(tmp_path):
    from timetuning_tpu.obs import logging as jlog
    from timetuning_tpu_torch.obs import logging as tlog

    outs = []
    for name, mod in (("j", jlog), ("t", tlog)):
        d = tmp_path / name
        w = mod.MetricsWriter(str(d), use_tensorboard=False)
        w.scalar("Loss/train", 0.5, 1)
        w.scalar("Loss/train", float("nan"), 2)
        w.histogram("h", np.arange(3), 3)
        w.close()
        mod.dump_config({"b": 2, "a": (1, 2)}, str(d))
        log = mod.make_file_logger(f"copy_{name}", str(d))
        log.info("x")
        outs.append([open(d / f).read() for f in ("metrics.jsonl", "config.txt")])
        assert os.path.exists(d / f"copy_{name}.log")
    assert outs[0] == outs[1]


def test_viz_matches(tmp_path):
    from timetuning_tpu.obs import viz as jviz
    from timetuning_tpu_torch.obs import viz as tviz

    np.testing.assert_array_equal(jviz.davis_palette(), tviz.davis_palette())
    seg = np.random.default_rng(0).integers(0, 300, (6, 5))
    img = np.random.default_rng(1).uniform(0, 1, (6, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(jviz.colorize_segmentation(seg), tviz.colorize_segmentation(seg))
    np.testing.assert_array_equal(jviz.overlay_segmentation(img, seg), tviz.overlay_segmentation(img, seg))
    np.testing.assert_array_equal(jviz.generate_colors(4), tviz.generate_colors(4))
    np.testing.assert_array_equal(jviz.denormalize(img, (0.4,) * 3, (0.2,) * 3),
                                  tviz.denormalize(img, (0.4,) * 3, (0.2,) * 3))
    frames = np.asarray(jviz.clip_overlay_frames(img[None], seg[None] % 3, (0.4,) * 3, (0.2,) * 3))
    np.testing.assert_array_equal(
        frames, np.asarray(tviz.clip_overlay_frames(img[None], seg[None] % 3, (0.4,) * 3, (0.2,) * 3)))
    for mod, name in ((jviz, "j.gif"), (tviz, "t.gif")):
        mod.write_gif([tviz.colorize_segmentation(seg % 4)] * 2, str(tmp_path / name))
    assert open(tmp_path / "j.gif", "rb").read() == open(tmp_path / "t.gif", "rb").read()


def test_optical_flow_matches():
    """The Farneback baseline on a moving textured box: the flows and the
    propagated masks equal."""
    from timetuning_tpu.eval import optical_flow as jof
    from timetuning_tpu_torch.eval import optical_flow as tof

    rng = np.random.default_rng(3)
    tex = rng.integers(60, 255, (16, 20, 3), dtype=np.uint8)
    frames = np.full((4, 48, 64, 3), 30, np.uint8)
    mask = np.zeros((48, 64), np.uint8)
    for t in range(4):
        frames[t, 10 + 2 * t:26 + 2 * t, 12 + 3 * t:32 + 3 * t] = tex
    mask[10:26, 12:32] = 1
    np.testing.assert_array_equal(tof.dense_optical_flow(frames),
                                  jof.dense_optical_flow(frames))
    np.testing.assert_array_equal(tof.propagate_flow(frames, mask),
                                  jof.propagate_flow(frames, mask))


def test_visor_conversion_matches(tmp_path):
    """Zips extracted and flat VISOR frames regrouped into the same DAVIS
    trees by both copies."""
    import zipfile

    from timetuning_tpu.data import visor as jvisor
    from timetuning_tpu_torch.data import visor as tvisor

    src = tmp_path / "zips"
    src.mkdir()
    with zipfile.ZipFile(src / "a.zip", "w") as zf:
        for sub in ("images", "annotations"):
            for v, f in (("P01_01", 3), ("P01_01", 7), ("P02_05", 1)):
                zf.writestr(f"rel/{sub}/{v}_frame_{f:010d}.jpg", f"{sub}{v}{f}")
    trees = {}
    for mod, name in ((jvisor, "j"), (tvisor, "t")):
        out = tmp_path / name
        tops = mod.extract_zips(str(src), str(out / "x"))
        assert [os.path.basename(t) for t in tops] == ["rel"]
        mod.visor_to_davis(str(out / "x" / "rel"), str(out / "davis"))
        assert mod.group_frames_by_video(str(out / "x" / "rel" / "images"),
                                         str(out / "again")) == 2
        trees[name] = sorted(
            (os.path.relpath(os.path.join(d, f), out / "davis"),
             open(os.path.join(d, f)).read())
            for d, _, fs in os.walk(out / "davis") for f in fs)
    assert trees["j"] == trees["t"] and len(trees["t"]) == 6


@pytest.mark.parametrize("dim,grid,cls", [(16, 4, True), (64, 14, False), (768, 14, True)])
def test_sincos_embeds_match(dim, grid, cls):
    from timetuning_tpu.models import embeds as jemb
    from timetuning_tpu_torch.models import embeds as temb

    np.testing.assert_array_equal(temb.get_2d_sincos_pos_embed(dim, grid, cls),
                                  jemb.get_2d_sincos_pos_embed(dim, grid, cls))


def test_import_torch_matches(tmp_path):
    import torch

    from timetuning_tpu.models import import_torch as jimp
    from timetuning_tpu_torch.models import import_torch as timp

    cfg = JViTConfig(patch_size=8, embed_dim=32, depth=2, num_heads=2, img_size=32)
    params = JVisionTransformer(cfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))["params"]
    head = {f"lin{i}": {"kernel": np.full((32 if i == 0 else 4, 4), i, np.float32),
                        "bias": np.zeros(4, np.float32)} for i in range(2)}
    full = {"feature_extractor": {"backbone": params, "head": head},
            "prototypes": np.ones((3, 4), np.float32)}
    path = str(tmp_path / "t.pth")
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in
                               jexport.timet_state_dict(full).items()}}, path)
    a, b = jimp.load_torch_state_dict(path), timp.load_torch_state_dict(path)
    assert list(a) == list(b)
    ta, tb = jimp.timet_params_from_torch(a), timp.timet_params_from_torch(b)
    la = jax.tree_util.tree_leaves_with_path(ta)
    lb = jax.tree_util.tree_leaves_with_path(tb)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (_, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(x, y)
    assert (jimp.head_dims_from_params(ta["feature_extractor"]["head"])
            == timp.head_dims_from_params(tb["feature_extractor"]["head"]) == (4, 4))
    sd = {"module.backbone.blocks.0.norm1.weight": np.ones(2)}
    assert list(jimp.strip_prefixes(sd)) == list(timp.strip_prefixes(sd))


def test_parity_oracle_matches():
    """The port's copy of eval/parity_oracle builds the same module (same
    keys, same outputs on the same weights), the same head, and loads a
    state dict as the original does."""
    torch.manual_seed(3)
    a = joracle.build_oracle(img_size=32, patch_size=8, dim=32, depth=2, heads=2)
    b = toracle.oracle_from_state_dict(a.state_dict(), 32, 2)
    x = torch.randn(2, 3, 48, 48)
    with torch.no_grad():
        ta, pa = a(x, return_probs=True)
        tb, pb = b(x, return_probs=True)
        torch.testing.assert_close(tb, ta, rtol=0, atol=0)
        torch.testing.assert_close(pb, pa, rtol=0, atol=0)
        torch.testing.assert_close(b.embed(x), a.embed(x), rtol=0, atol=0)
    ha, hb = joracle.build_oracle_head((48, 24), 32), toracle.build_oracle_head((48, 24), 32)
    assert list(ha.state_dict()) == list(hb.state_dict())
    assert [type(m) for m in ha] == [type(m) for m in hb]
