"""The port's checkpoint module (core/checkpoint.py) and the converter's
inverse (models/convert.timet_params_to_jax).

* the run-directory helpers, against the JAX package's on the same trees;
* save -> load restores every state field (model, AdamW moments by name,
  teacher, queue and fill, step, epoch) and the meta sidecar; a checkpoint
  of the optimizer over the trainable subtree loads into one over the full
  tree;
* exact resume on the CPU: k steps, save, load into a fresh state, k more
  steps equal 2k steps bit for bit;
* ``export_best`` writes the published TimeT.pth layout: the same keys and
  values as the JAX package's export of the same weights;
* ``timet_params_to_jax`` is the inverse of ``timet_state_dict_from_jax``
  (a round trip, exact), and ``import_timet_pth`` reads a JAX export back.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_timet import K, UNFREEZE, _clips, _jax_model, _torch_model
from timetuning_tpu.core import checkpoint as jck
from timetuning_tpu.models import export_torch as jexport
from timetuning_tpu_torch.core import checkpoint as tck
from timetuning_tpu_torch.core import timet as tt
from timetuning_tpu_torch.core.optimizer import swav_optimizer
from timetuning_tpu_torch.models.convert import (
    timet_params_to_jax,
    timet_state_dict_from_jax,
)

torch.set_num_threads(2)
SCHED = dict(num_epochs=1, steps_per_epoch=10)


def test_run_directory_helpers_match(tmp_path):
    base = tmp_path / "logs"
    assert tck.find_last_run_directory(str(base)) is None
    for day, times in (("20260101", ["090000", "120000"]), ("20260102", ["080000"]),
                       ("notaday", ["999999"])):
        for t in times:
            (base / day / t).mkdir(parents=True)
    (base / "20260103").mkdir()                      # a day without runs
    assert tck.find_last_run_directory(str(base)) == jck.find_last_run_directory(str(base))
    assert tck.find_last_run_directory(str(base)).endswith(os.path.join("20260102", "080000"))
    made = tck.make_run_directory(str(tmp_path / "new"))
    day, t = made.split(os.sep)[-2:]
    assert os.path.isdir(made) and len(day) == 8 and len(t) == 6


def _build(opt_over_trainable=True, use_queue=True, seed=0):
    model = _torch_model().init_weights(torch.Generator().manual_seed(seed))
    cfg = tt.TimeTConfig(n_prototypes=K, spatial_resolution=4, frozen_trunk_blocks=1,
                         use_queue=use_queue, queue_size=40, **SCHED)
    opt, mask = swav_optimizer(model, lr=1e-3, unfreeze_layers=UNFREEZE,
                               opt_over_trainable=opt_over_trainable, **SCHED)
    state = tt.init_state(model, cfg, opt,
                          trainable_mask=mask if opt_over_trainable else None)
    step = tt.make_train_step(model, cfg, opt, trainable_mask=mask,
                              opt_over_trainable=opt_over_trainable)
    return state, step


def _run(state, step, clips, start):
    losses = []
    for i, clip in enumerate(clips):
        g = torch.Generator().manual_seed(1000 + start + i)
        state, m = step(state, torch.from_numpy(clip), g)
        losses.append(float(m["loss"]))
    return losses


def _tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"teacher.{k}": v for k, v in (state.teacher or {}).items()})
    for n, p in state.opt.named_params.items():
        for k, v in state.opt.adamw.state.get(p, {}).items():
            out[f"adam.{n}.{k}"] = v
    if state.queue is not None:
        out["queue"] = state.queue
    return out


def _assert_equal_states(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert (a.step, a.queue_fill, a.opt.count) == (b.step, b.queue_fill, b.opt.count)


def test_save_load_round_trip(tmp_path):
    clips = _clips(2)
    state, step = _build()
    _run(state, step, clips, 0)
    meta = {"world_size": 1, "queue_rows_per_device": 40, "best_score": 0.25,
            "steps_per_epoch": 10}
    path = tck.save_checkpoint(state, str(tmp_path), 3, meta=meta)
    assert os.path.basename(path) == "checkpoint.pt"
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    fresh, _ = _build(seed=5)
    loaded, epoch = tck.load_checkpoint(str(tmp_path), fresh)
    assert epoch == 3 and loaded is fresh
    _assert_equal_states(state, loaded)
    assert tck.load_checkpoint_meta(str(tmp_path)) == meta
    assert json.load(open(tmp_path / "checkpoint_meta.json")) == meta
    # absent checkpoint: the template and epoch 0, as the reference's resume
    other, _ = _build()
    assert tck.load_checkpoint(str(tmp_path / "none"), other) == (other, 0)
    assert tck.load_checkpoint_meta(str(tmp_path / "none")) is None


def test_subtree_checkpoint_loads_into_full_tree_optimizer(tmp_path):
    clips = _clips(2)
    state, step = _build(opt_over_trainable=True)
    _run(state, step, clips, 0)
    tck.save_checkpoint(state, str(tmp_path), 1)
    full, full_step = _build(opt_over_trainable=False)
    tck.load_checkpoint(str(tmp_path), full)
    for n, p in full.opt.named_params.items():
        trains = full.opt.trainable_mask[n]
        assert (p in full.opt.adamw.state) == trains, n
    # both continue the same trajectory
    a = _run(state, step, _clips(1, seed=3), 2)
    b = _run(full, full_step, _clips(1, seed=3), 2)
    assert a == b
    for n, p in state.model.named_parameters():
        assert torch.equal(p, dict(full.model.named_parameters())[n]), n


@pytest.mark.parametrize("k", [1, 2])
def test_exact_resume_k_plus_k_equals_2k(tmp_path, k):
    clips = _clips(2 * k, seed=1)
    straight, step = _build()
    want = _run(straight, step, clips, 0)
    first, step1 = _build()
    got = _run(first, step1, clips[:k], 0)
    tck.save_checkpoint(first, str(tmp_path), 0)
    resumed, step2 = _build(seed=9)
    tck.load_checkpoint(str(tmp_path), resumed)
    got += _run(resumed, step2, clips[k:], k)
    assert got == want
    _assert_equal_states(straight, resumed)


def _jax_tree():
    params = _jax_model().init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def test_export_best_matches_jax_export(tmp_path):
    params = _jax_tree()
    model = _torch_model()
    model.load_state_dict(timet_state_dict_from_jax(params))
    path = tck.export_best(model, str(tmp_path), 0.123456, 7)
    assert os.path.basename(path) == "0.1235_7.pth"
    got = torch.load(path, weights_only=True)
    want = jexport.timet_state_dict(params)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    assert "feature_extractor.head.2.weight" in got      # Sequential index 2 j
    # the published layout reads back into the port's names
    back = tck.import_timet_pth(path)
    own = model.state_dict()
    assert back.keys() == own.keys()
    for key in own:
        assert torch.equal(back[key], own[key]), key


def test_jax_export_imports_into_the_port(tmp_path):
    """A ``.pth`` written by the JAX package's exporter loads into the port."""
    params = _jax_tree()
    path = str(tmp_path / "jax.pth")
    jexport.save_timet_pth(params, path)
    sd = tck.import_timet_pth(path)
    model = _torch_model()
    model.load_state_dict(sd)
    want = timet_state_dict_from_jax(params)
    for key in want:
        assert torch.equal(model.state_dict()[key], want[key]), key


def test_converter_round_trip():
    """state dict -> JAX tree -> state dict is the identity, and the tree has
    the JAX model's own structure."""
    params = _jax_tree()
    sd = timet_state_dict_from_jax(params)
    tree = timet_params_to_jax(sd)
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, params)))
    back = timet_state_dict_from_jax(tree)
    assert back.keys() == sd.keys()
    for key in sd:
        assert torch.equal(back[key], sd[key]), key
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves_with_path(params)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
