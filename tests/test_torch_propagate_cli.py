"""The whole slice: the port's propagation CLI against the JAX package's on
a synthetic DAVIS tree (a moving coloured box), with the same JAX-initialised
weights written to a reference-layout .pth; and the port CLI run in a
process of its own, where jax is never imported."""

import ast
import os
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

import timetuning_tpu.data.loader  # noqa: F401  (the port reuses it)
from timetuning_tpu.cli import propagate as jcli
from timetuning_tpu.models.registry import get_backbone as j_get_backbone
from timetuning_tpu_torch.cli import propagate as tcli
from timetuning_tpu_torch.models.convert import vit_state_dict_from_jax

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def davis_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("davis_port")
    for v in range(2):
        fdir = root / "JPEGImages" / "480p" / f"video{v}"
        adir = root / "Annotations" / "480p" / f"video{v}"
        fdir.mkdir(parents=True)
        adir.mkdir(parents=True)
        for f in range(6):
            img = np.full((64, 64, 3), 30, np.uint8)
            y = 16 + f + 3 * v
            img[y:y + 24, 20:44] = [220, 40, 40]           # moving red box
            cv2.imwrite(str(fdir / f"{f:05d}.jpg"), img)
            ann = np.zeros((64, 64), np.uint8)
            ann[y:y + 24, 20:44] = 1
            cv2.imwrite(str(adir / f"{f:05d}.png"), ann)
    return str(root)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """vit-tiny-test, initialised by the JAX package and perturbed so every
    parameter is non-trivial, as a timm-layout .pth."""
    params = j_get_backbone("vit-tiny-test").variables["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    path = tmp_path_factory.mktemp("w") / "vit_tiny.pth"
    torch.save(vit_state_dict_from_jax(params), path)
    return str(path)


def _argv(tree, weights, dtype="float32"):
    return ["--architecture", "vit-tiny-test", "--model_path", weights,
            "--dataset", "davis_val", "--data_root", tree, "--num_frames", "4",
            "--n_last_frames", "2", "--size_mask_neighborhood", "2",
            "--input_resolution", "64", "--metric", "jf", "--num_workers", "2",
            "--compute_dtype", dtype]


def _jf(out: str) -> dict:
    line = [ln for ln in out.splitlines() if ln.startswith("J&F: ")][-1]
    return ast.literal_eval(line[len("J&F: "):])


def test_port_cli_matches_jax_cli(davis_tree, weights, capsys):
    assert jcli.main(_argv(davis_tree, weights)) == 0
    want = _jf(capsys.readouterr().out)
    assert tcli.main(_argv(davis_tree, weights) + ["--device", "cpu"]) == 0
    got = _jf(capsys.readouterr().out)
    assert want["J"] > 0.3, want          # the box is tracked, not degenerate
    for key in ("J", "F", "J&F"):
        assert abs(got[key] - want[key]) <= 1e-4, (got, want)


def test_port_cli_bf16_close_to_f32(davis_tree, weights, capsys):
    scores = {}
    for dt in ("float32", "bfloat16"):
        assert tcli.main(_argv(davis_tree, weights, dt) + ["--device", "cpu"]) == 0
        scores[dt] = _jf(capsys.readouterr().out)
    assert abs(scores["float32"]["J&F"] - scores["bfloat16"]["J&F"]) <= 0.05, scores


def test_port_cli_never_imports_jax(davis_tree, weights):
    code = (
        "import sys\n"
        "from timetuning_tpu_torch.cli.propagate import main\n"
        f"rc = main({_argv(davis_tree, weights, 'bfloat16') + ['--device', 'cpu']!r})\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert 0.0 <= _jf(proc.stdout)["J&F"] <= 1.0


def test_default_device_is_the_card_or_an_error(monkeypatch):
    """Without ``--device`` the CLIs run on the card and raise where there is
    none; the CPU is taken only when asked for."""
    from timetuning_tpu_torch.cli import linear_probe as lp

    assert lp.default_device is tcli.default_device
    parse = tcli.build_parser().parse_args
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.default_device(parse([]))
    assert tcli.default_device(parse(["--device", "cpu"])) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tcli.default_device(parse([])) == torch.device("cuda")
    assert tcli.default_device(parse(["--device", "cpu"])) == torch.device("cpu")
    lp_args = lp.build_parser().parse_args(["--pascal_root", "unused"])
    assert lp_args.device is None and tcli.default_device(lp_args) == torch.device("cuda")


def test_get_backbone_without_device_raises_where_there_is_no_card(monkeypatch):
    """The public constructor builds on the card by default, as the CLIs do;
    the host only when the caller names it."""
    from timetuning_tpu_torch.models.registry import get_backbone

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_backbone("vit-tiny-test")
    bb = get_backbone("vit-tiny-test", device="cpu")
    assert next(bb.module.parameters()).device == torch.device("cpu")


@pytest.mark.parametrize("cli", ["propagate", "linear_probe"])
def test_clis_without_device_raise_where_there_is_no_card(monkeypatch, davis_tree,
                                                          weights, cli):
    """Neither CLI takes the CPU in silence: with no card and no ``--device``
    ``main`` raises before it loads a model or reads data."""
    from timetuning_tpu_torch.cli import linear_probe as lp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device found"):
        if cli == "propagate":
            tcli.main(_argv(davis_tree, weights))
        else:
            lp.main(["--pascal_root", "does-not-exist", "--architecture",
                     "vit-tiny-test"])


def test_str2bool_copy_matches_original():
    import argparse

    from timetuning_tpu.cli.train import str2bool as original

    for v in ("1", "true", "Yes", "y", "T", "0", "false", "NO", "n", "f"):
        assert tcli.str2bool(v) == original(v), v
    for fn in (tcli.str2bool, original):
        with pytest.raises(argparse.ArgumentTypeError):
            fn("treu")


@pytest.mark.parametrize("flags,item", [
    (["--use_optical_flow", "true"], "Remaining propagate CLI options"),
])
def test_unported_options_raise_naming_their_roadmap_item(davis_tree, weights, capsys,
                                                          flags, item):
    """The options that once raised naming their ROADMAP item (``item``, the
    optical-flow baseline of queue 1 item 7) are ported: each now runs and
    prints the JAX CLI's scores (the JAX test is tests/test_cli.py's
    ``test_propagate_cli_optical_flow``), to 1e-6."""
    argv = _argv(davis_tree, weights)
    argv = [a for a in argv if a not in ("--metric", "jf")] + flags + ["--metric", "jf"]
    assert jcli.main(argv) == 0
    want = _jf(capsys.readouterr().out)
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got = _jf(capsys.readouterr().out)
    assert want["J"] > 0.3, want          # the flow follows the box
    for key in ("J", "F", "J&F"):
        assert abs(got[key] - want[key]) <= 1e-6, (got, want, item)


@pytest.mark.parametrize("metric,extra", [
    ("miou", []),
    ("miou", ["--evaluation_protocol", "sample-wise", "--many_to_one", "true"]),
    ("propagation", []),
])
def test_miou_and_propagation_metrics_match_jax_cli(davis_tree, weights, capsys,
                                                    metric, extra):
    """``--metric miou`` (PredsmIoU(num_clusters, 10, involve_bg=False) under
    the protocol) and ``--metric propagation`` (per-object J) on the same
    propagated masks as the JAX CLI: equal to 1e-6."""
    argv = [a for a in _argv(davis_tree, weights) if a not in ("--metric", "jf")]
    argv += ["--metric", metric] + extra
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    label = "propagation J: " if metric == "propagation" else "mIoU: "
    assert got.startswith(label) and want.startswith(label), (got, want)
    g, w = float(got[len(label):]), float(want[len(label):])
    assert 0.0 < w <= 1.0 and abs(g - w) <= 1e-6, (g, w)


@pytest.mark.parametrize("protocol", ["dataset-wise", "frame-wise"])
def test_evaluate_cli_matches_jax_cli(davis_tree, weights, capsys, monkeypatch, protocol):
    """``cli/evaluate`` against the JAX CLI on the same weights and tree: the
    same score to 1e-6, k-means drawing JAX's values (mirrored keys: one fit
    dataset-wise; frame-wise a fit a frame, per batch of 2 clips x 2 frames)."""
    from test_torch_kmeans import mirror_keys
    from timetuning_tpu.cli import evaluate as jev_cli
    from timetuning_tpu_torch.cli import evaluate as tev_cli

    argv = ["--architecture", "vit-tiny-test", "--model_path", weights,
            "--dataset", "davis_val", "--data_root", davis_tree, "--batch_size", "2",
            "--num_frames", "2", "--input_resolution", "32", "--eval_resolution", "16",
            "--num_clusters", "2", "--evaluation_protocol", protocol,
            "--num_workers", "2"]
    assert jev_cli.main(argv) == 0
    want = float(capsys.readouterr().out.split("score: ")[1].split()[0])
    k1 = jax.random.PRNGKey(1)
    mirror_keys(monkeypatch, [k1] if protocol == "dataset-wise" else list(jax.random.split(k1, 4)))
    assert tev_cli.main(argv + ["--device", "cpu"]) == 0
    got = float(capsys.readouterr().out.split("score: ")[1].split()[0])
    assert 0.3 < want <= 1.0 and abs(got - want) <= 1e-6, (got, want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device found"):
        tev_cli.main(argv)
