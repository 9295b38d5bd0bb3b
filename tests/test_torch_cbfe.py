"""The port's CBFE (eval/bfscore.py, eval/cbfe.py, cli/cbfe.py) against the
JAX package's on the same inputs: the boundary F, the per-cluster
statistics and the threshold sweep, the whole foreground extraction on
JAX's k-means draws (mirrored keys, tests/test_torch_kmeans.py), and the
CLI on a synthetic VOC tree with the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kmeans import mirror_keys
from timetuning_tpu.cli import cbfe as jcli
from timetuning_tpu.eval import bfscore as jbf
from timetuning_tpu.eval import cbfe as jcbfe
from timetuning_tpu.models.registry import get_backbone as j_get_backbone
from timetuning_tpu_torch.cli import cbfe as tcli
from timetuning_tpu_torch.eval import bfscore as tbf
from timetuning_tpu_torch.eval import cbfe as tcbfe
from timetuning_tpu_torch.models.convert import vit_state_dict_from_jax

torch.set_num_threads(2)

cv2 = pytest.importorskip("cv2")


def _blobs(n, size, seed, classes=2):
    """[n, size, size] maps of a few rectangles of classes 1..classes."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, size, size), np.int64)
    for i in range(n):
        for c in range(1, classes + 1):
            y, x = rng.integers(0, size - 6, 2)
            h, w = rng.integers(3, 9, 2)
            out[i, y:y + h, x:x + w] = c
    return out


@pytest.mark.parametrize("threshold", [1, 2, 3])
def test_bfscore_matches_jax(threshold):
    """Per class (class 0 skipped, a class in neither map None) and the
    mean; exact up to f32 rounding."""
    gt, pred = _blobs(1, 24, threshold, 3)[0], _blobs(1, 24, threshold + 10, 2)[0]
    gt[gt == 3] = 4                                    # class 3 in neither map
    want_s, want_m = jbf.bfscore(gt, pred, threshold)
    got_s, got_m = tbf.bfscore(gt, pred, threshold)
    assert got_s.keys() == want_s.keys()
    for c, w in want_s.items():
        assert (got_s[c] is None) == (w is None)
        if w is not None:
            assert abs(got_s[c] - w) <= 1e-6, c
    assert abs(got_m - want_m) <= 1e-6
    s, m = tbf.bfscore(np.zeros((8, 8), np.int64), np.zeros((8, 8), np.int64))
    assert s == {} and m == 0.0


@pytest.mark.parametrize("n", [1, 7])
def test_evaluate_bf_score_matches_jax_in_one_batched_call(n):
    gt = _blobs(n, 32, n) > 0
    fg = _blobs(n, 32, n + 1) > 0
    fg[0] = gt[0]                                      # one perfect frame
    want = jbf.evaluate_bf_score(gt, fg)
    assert abs(tbf.evaluate_bf_score(gt, fg) - want) <= 1e-6
    assert abs(tbf.evaluate_bf_score(torch.from_numpy(gt), torch.from_numpy(fg)) - want) <= 1e-6


def _cluster_case(seed, K=12, M=5, r=10):
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, K, (M, r, r))
    fg_clusters = rng.uniform(size=K) < 0.4
    attn = (fg_clusters[assign] ^ (rng.uniform(size=assign.shape) < 0.15)).astype(np.float32)
    gt = fg_clusters[assign] ^ (rng.uniform(size=assign.shape) < 0.1)
    return assign, attn, gt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cluster_statistics_and_threshold_match_jax(seed):
    """Per-cluster precision, the masks at a threshold, and the sweep's
    threshold (exactly) and train Jaccard."""
    assign, attn, gt = _cluster_case(seed)
    cfg_j, cfg_t = jcbfe.CBFEConfig(num_clusters=12), tcbfe.CBFEConfig(num_clusters=12)
    pj = jcbfe.cluster_precisions(jnp.asarray(assign), jnp.asarray(attn), 12)
    pt = tcbfe.cluster_precisions(torch.from_numpy(assign), torch.from_numpy(attn), 12)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(
        tcbfe.masks_from_threshold(torch.from_numpy(assign), pt, 0.5).numpy(),
        np.asarray(jcbfe.masks_from_threshold(jnp.asarray(assign), pj, 0.5)))
    th_j, jac_j = jcbfe.find_good_threshold(assign, pj, gt, cfg_j)
    th_t, jac_t = tcbfe.find_good_threshold(torch.from_numpy(assign), pt,
                                            torch.from_numpy(gt), cfg_t)
    assert th_t == th_j and abs(round(th_t * 20) - th_t * 20) < 1e-9
    assert abs(jac_t - jac_j) <= 1e-12


def test_foreground_masks_match_jax_on_mirrored_kmeans(monkeypatch):
    """The whole extraction on the same features and attention masks (two
    splits of 6 and 4 images, features [B, 1, 16, 8] on a 4 x 4 grid, k = 5
    at resolution 8): JAX's k-means draws for its PRNGKey(1) of each split
    handed to the port."""
    rng = np.random.default_rng(3)

    def split(n, seed):
        r = np.random.default_rng(seed)
        fg = r.uniform(size=(n, 4, 4)) < 0.4
        feats = (r.standard_normal((n, 1, 16, 8)) * 0.3
                 + 2.0 * fg.reshape(n, 1, 16, 1)).astype(np.float32)
        attn = (fg ^ (r.uniform(size=fg.shape) < 0.1)).astype(np.float32)
        gt = np.kron(fg, np.ones((2, 2), np.uint8)).astype(np.uint8)    # [n, 8, 8]
        return [(i, feats[i:i + 3], attn[i:i + 3], gt[i:i + 3]) for i in range(0, n, 3)]

    tr, va = split(6, 4), split(4, 5)
    del rng

    def run(mod, to, keys=None):
        def fn(b):
            return to(b[0]), to(b[1])

        loader = lambda s: [((f, a), g) for _, f, a, g in s]      # noqa: E731
        cb = mod.ClusterBasedForegroundExtraction(
            lambda frames: fn(frames), mod.CBFEConfig(num_clusters=5, resolution=8))
        return cb.get_foreground_masks(loader(tr), loader(va))

    want = run(jcbfe, jnp.asarray)
    k1 = jax.random.PRNGKey(1)
    mirror_keys(monkeypatch, [k1, k1])
    got = run(tcbfe, torch.from_numpy)
    assert got["threshold"] == want["threshold"]
    for key in ("train_jaccard", "val_jaccard", "val_bf"):
        assert abs(got[key] - want[key]) <= 1e-6, key
    np.testing.assert_array_equal(got["fg_masks"], np.asarray(want["fg_masks"]))


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    """tests/test_pascal_clis.py's synthetic VOC tree: six 64 x 64 images of a
    red box, three a split."""
    root = tmp_path_factory.mktemp("voc_cbfe")
    for d in ("images", "SegmentationClass", "SegmentationClassAug", "sets"):
        (root / d).mkdir()
    rng = np.random.default_rng(0)
    names = [f"img{i}" for i in range(6)]
    for n in names:
        img = np.full((64, 64, 3), 40, np.uint8)
        mask = np.zeros((64, 64), np.uint8)
        y = rng.integers(8, 24)
        img[y:y + 24, 16:48] = [200, 60, 60]
        mask[y:y + 24, 16:48] = 1
        cv2.imwrite(str(root / "images" / f"{n}.jpg"), img[..., ::-1])
        cv2.imwrite(str(root / "SegmentationClass" / f"{n}.png"), mask)
        cv2.imwrite(str(root / "SegmentationClassAug" / f"{n}.png"), mask)
    (root / "sets" / "val.txt").write_text("\n".join(names[:3]))
    (root / "sets" / "trainaug.txt").write_text("\n".join(names[3:]))
    return str(root)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    params = j_get_backbone("vit-tiny-test").variables["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    path = tmp_path_factory.mktemp("w_cbfe") / "vit_tiny.pth"
    torch.save(vit_state_dict_from_jax(params), path)
    return str(path)


def _argv(tree, weights):
    """The flags of tests/test_pascal_clis.py's CBFE smoke run."""
    return ["--architecture", "vit-tiny-test", "--model_path", weights,
            "--pascal_root", tree, "--batch_size", "3", "--num_clusters", "6",
            "--input_resolution", "32", "--resolution", "16",
            "--eval_resolution", "16", "--num_eval_clusters", "2"]


def test_cbfe_cli_matches_jax_cli(voc_tree, weights, monkeypatch, capsys):
    """The five numbers of ``cli/cbfe --device cpu`` against the JAX CLI's on
    the same tree and weights, k-means on JAX's draws (its PRNGKey(1) for
    each split's overclustering and for the masked Evaluator's fit)."""
    want = jcli.run_cbfe(jcli.build_parser().parse_args(_argv(voc_tree, weights)))
    k1 = jax.random.PRNGKey(1)
    mirror_keys(monkeypatch, [k1, k1, k1])
    got = tcli.run_cbfe(tcli.build_parser().parse_args(
        _argv(voc_tree, weights) + ["--device", "cpu"]))
    assert got.keys() == want.keys()
    assert got["threshold"] == want["threshold"]
    for key in ("train_jaccard", "val_jaccard", "val_bf", "masked_miou"):
        assert abs(got[key] - want[key]) <= 1e-6, (key, got, want)
    out = capsys.readouterr().out
    assert "threshold=" in out and "masked dataset-wise mIoU" in out


def test_cbfe_cli_main_prints_and_raises_without_a_card(voc_tree, weights, monkeypatch,
                                                        capsys):
    assert tcli.main(_argv(voc_tree, weights) + ["--device", "cpu"]) == 0
    assert "threshold=" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device found"):
        tcli.main(_argv(voc_tree, weights))
    args = tcli.build_parser().parse_args(["--pascal_root", "x"])
    assert (args.architecture, args.batch_size, args.num_clusters, args.input_resolution,
            args.resolution, args.eval_resolution, args.num_eval_clusters,
            args.many_to_one, args.device) == ("dino-s16", 32, 300, 448, 100, 100, 21,
                                               True, None)
