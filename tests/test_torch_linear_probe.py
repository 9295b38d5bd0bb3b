"""The port's linear probe (timetuning_tpu_torch/models/heads.py,
eval/linear_probe.py, cli/linear_probe.py) against the JAX package's: the
head on carried weights, the trainer's loss and parameters step by step on
the same fixed features, and the CLI on a synthetic Pascal VOC tree with the
same backbone weights and head init; and the port CLI run in a process of
its own, where jax is never imported."""

import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetuning_tpu.cli import linear_probe as jcli
from timetuning_tpu.eval.linear_probe import LinearProbeConfig as JConfig
from timetuning_tpu.eval.linear_probe import LinearProbeTrainer as JTrainer
from timetuning_tpu.models.heads import LinearProbeHead as JHead
from timetuning_tpu.models.registry import get_backbone as j_get_backbone
from timetuning_tpu_torch.cli import linear_probe as tcli
from timetuning_tpu_torch.eval import linear_probe as tlp
from timetuning_tpu_torch.models.convert import (
    linear_probe_head_state_dict_from_jax,
    vit_state_dict_from_jax,
)
from timetuning_tpu_torch.models.heads import LinearProbeHead

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_head_params(num_classes, res, dim):
    """The JAX trainer's own head init (eval/linear_probe.py:93-97)."""
    return JHead(num_classes).init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, res, res, dim)))["params"]


def test_head_matches_jax_on_carried_weights():
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * np.random.default_rng(0).standard_normal(a.shape)
        .astype(np.float32), _jax_head_params(5, 4, 8))
    x = np.random.default_rng(1).standard_normal((2, 4, 4, 8)).astype(np.float32)
    want = JHead(5).apply({"params": params}, jnp.asarray(x))
    head = LinearProbeHead(8, 5)
    head.load_state_dict(linear_probe_head_state_dict_from_jax(params))
    with torch.no_grad():
        got = head(torch.from_numpy(x))
    assert got.shape == (2, 4, 4, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_head_init_draws_from_flax_distribution():
    """The seeded init against JAX's own head init at D=384, C=21 (8,064
    weights): the same truncation point and the same std (within the 3 %
    a sample of this size allows), zero bias."""
    want = np.asarray(_jax_head_params(21, 2, 384)["conv"]["kernel"])
    head = LinearProbeHead(384, 21).init_weights(torch.Generator().manual_seed(0))
    got = head.conv.weight.detach().numpy()
    assert np.abs(got.std() / want.std() - 1) < 0.03
    bound = 2 * 384 ** -0.5 / 0.87962566103423978
    assert np.abs(got).max() <= bound and np.abs(want).max() <= bound * (1 + 1e-6)
    assert not head.conv.bias.detach().any()


def test_trainer_trajectory_matches_jax():
    """Nine SGD steps (3 epochs of 3 batches) with the lr dropping after
    epochs 1 and 2, one all-ignored batch (loss 0, only weight decay and
    momentum move the head) and a partly ignored one: loss and head
    parameters after every step equal to the JAX trainer's (rtol 1e-5),
    then the same validation mIoU."""
    res, C, D, steps_per_epoch = 4, 3, 8, 3
    rng = np.random.default_rng(0)
    W = rng.standard_normal((C, D)).astype(np.float32) * 2
    batches = []
    for i in range(steps_per_epoch):
        labels = rng.integers(0, C, size=(2, res, res))
        feats = W[labels] + 0.5 * rng.standard_normal((2, res, res, D)).astype(np.float32)
        masks = np.kron(labels, np.ones((4, 4), int)).astype(np.uint8)
        if i == 1:
            masks[:] = 255                           # all ignored
        if i == 2:
            masks[:, :5] = 255                       # partly ignored
        batches.append((feats.reshape(2, res * res, D), masks))

    kw = dict(num_classes=C, mask_size=16, lr=0.5, lr_drop_every=1,
              num_epochs=3)
    jtr = JTrainer(jnp.asarray, res, JConfig(**kw), steps_per_epoch)
    ttr = tlp.LinearProbeTrainer(torch.from_numpy, res, tlp.LinearProbeConfig(**kw),
                                 steps_per_epoch)
    assert ttr.boundaries == [3, 6, 9]
    assert [ttr.lr_at(n) for n in (0, 2, 3, 5, 6, 8)] == pytest.approx(
        [0.5, 0.5, 0.05, 0.05, 0.005, 0.005])
    jtr.init(jnp.asarray(batches[0][0]))
    ttr.init(torch.from_numpy(batches[0][0]))
    ttr.head.load_state_dict(linear_probe_head_state_dict_from_jax(jtr.params))
    for step in range(3 * steps_per_epoch):
        feats, masks = batches[step % steps_per_epoch]
        jtr.params, jtr.opt_state, jloss = jtr._step(
            jtr.params, jtr.opt_state, jnp.asarray(feats), jnp.asarray(masks))
        tloss = ttr.train_step(torch.from_numpy(feats), torch.from_numpy(masks))
        if step % steps_per_epoch == 1:
            assert tloss == 0.0
        np.testing.assert_allclose(tloss, float(jloss), rtol=1e-5, atol=1e-7)
        want = linear_probe_head_state_dict_from_jax(jtr.params)
        for name, p in ttr.head.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {step} {name}")
    val = [batches[0], batches[2]]
    assert ttr.validate(val) == pytest.approx(jtr.validate(val), abs=1e-12)


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    """The synthetic VOC tree of tests/test_pascal_clis.py: a red box on a
    grey field, six images, three for each split."""
    root = tmp_path_factory.mktemp("voc_port")
    for sub in ("images", "SegmentationClass", "SegmentationClassAug", "sets"):
        (root / sub).mkdir()
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
    """vit-tiny-test, initialised by the JAX package and perturbed, as a
    timm-layout .pth that both CLIs load."""
    params = j_get_backbone("vit-tiny-test").variables["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    path = tmp_path_factory.mktemp("w") / "vit_tiny.pth"
    torch.save(vit_state_dict_from_jax(params), path)
    return str(path)


def _argv(tree, weights):
    return ["--architecture", "vit-tiny-test", "--model_path", weights,
            "--pascal_root", tree, "--batch_size", "2", "--num_classes", "2",
            "--num_epochs", "2", "--input_resolution", "32", "--mask_size", "16",
            "--lr", "0.5"]


def test_port_cli_matches_jax_cli(voc_tree, weights, monkeypatch, capsys):
    """The same backbone weights and the JAX trainer's head init (the port
    draws its own from a torch generator): the same best and final mIoU
    over 2 epochs of 2 steps."""
    want = jcli.run_linear_probe(jcli.build_parser().parse_args(_argv(voc_tree, weights)))
    orig = tlp.LinearProbeTrainer.init

    def init_as_jax(self, sample_feats):
        orig(self, sample_feats)
        self.head.load_state_dict(linear_probe_head_state_dict_from_jax(
            _jax_head_params(self.cfg.num_classes, self.res, sample_feats.shape[-1])))

    monkeypatch.setattr(tlp.LinearProbeTrainer, "init", init_as_jax)
    args = tcli.build_parser().parse_args(_argv(voc_tree, weights) + ["--device", "cpu"])
    got = tcli.run_linear_probe(args)
    assert got == pytest.approx(want, abs=1e-9)
    assert 0.0 < got["best_miou"] <= 1.0
    assert tcli.main(_argv(voc_tree, weights) + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "epoch 1: loss=" in out and "val mIoU" in out


def test_port_cli_never_imports_jax(voc_tree, weights):
    code = (
        "import sys\n"
        "from timetuning_tpu_torch.cli.linear_probe import main\n"
        f"rc = main({_argv(voc_tree, weights) + ['--device', 'cpu']!r})\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "val mIoU" in proc.stdout
