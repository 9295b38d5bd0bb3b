"""The port's checkpoint module (core/checkpoint.py) and the converter's
inverse (models/convert.timet_params_to_jax).

* the run-directory helpers, against the JAX package's on the same trees;
* save -> load restores every state field (model, AdamW moments by name,
  teacher, queue and fill, step, epoch) and the meta sidecar; a checkpoint
  of the optimizer over the trainable subtree loads into one over the full
  tree;
* exact resume on the CPU: k steps, save, load into a fresh state, k more
  steps equal 2k steps bit for bit;
* the ``CheckpointWriter``: a save through it writes the same files as a
  synchronous save; the file holds the state of the call, though the state
  changes in place while the write waits; its host buffers are reused; a
  failed write raises at the next join;
* ``export_best`` writes the published TimeT.pth layout: the same keys and
  values as the JAX package's export of the same weights;
* ``timet_params_to_jax`` is the inverse of ``timet_state_dict_from_jax``
  (a round trip, exact), and ``import_timet_pth`` reads a JAX export back.
"""

import json
import os
import shutil
import threading

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


def _writer_threads():
    return [t for t in threading.enumerate() if t.name == "checkpoint-writer"]


def _assert_same_payload(a, b, path="payload"):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_same_payload(a[k], b[k], f"{path}.{k}")
    elif torch.is_tensor(a):
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def _hold_writes(monkeypatch):
    """Writes wait for the returned event before they start."""
    go = threading.Event()
    write = tck._atomic_write

    def held(path, fn):
        assert go.wait(60)
        write(path, fn)

    monkeypatch.setattr(tck, "_atomic_write", held)
    return go


@pytest.mark.parametrize("opt_over_trainable", [True, False])
def test_writer_save_equals_synchronous_save(tmp_path, opt_over_trainable):
    state, step = _build(opt_over_trainable=opt_over_trainable)
    _run(state, step, _clips(2), 0)
    meta = {"world_size": 1, "best_score": 0.5, "steps_per_epoch": 10}
    sync, threaded = tmp_path / "sync", tmp_path / "thread"
    sync.mkdir()
    threaded.mkdir()
    tck.save_checkpoint(state, str(sync), 2, meta=meta)
    writer = tck.CheckpointWriter()
    path = tck.save_checkpoint(state, str(threaded), 2, meta=meta, writer=writer)
    writer.join()
    assert path == str(threaded / "checkpoint.pt") and not _writer_threads()
    _assert_same_payload(torch.load(sync / "checkpoint.pt", weights_only=True),
                         torch.load(threaded / "checkpoint.pt", weights_only=True))
    assert ((threaded / "checkpoint_meta.json").read_text()
            == (sync / "checkpoint_meta.json").read_text())
    assert sorted(os.listdir(threaded)) == ["checkpoint.pt", "checkpoint_meta.json"]


def test_writer_file_holds_the_state_of_the_call(tmp_path, monkeypatch):
    """The state, the counters and ``meta`` change right after the save
    returns, while its write waits: the file holds them as they were at the
    call, and the join finds the write still running."""
    state, step = _build()
    _run(state, step, _clips(2), 0)
    want = {k: v.clone() for k, v in _tensors(state).items()}
    counters = (state.step, state.queue_fill, state.opt.count)
    meta = {"best_score": 0.25}
    go = _hold_writes(monkeypatch)
    writer = tck.CheckpointWriter()
    tck.save_checkpoint(state, str(tmp_path), 4, meta=meta, writer=writer)
    with torch.no_grad():
        for t in _tensors(state).values():
            t.add_(1.0)
    state.step += 1
    state.queue_fill = 0
    state.opt.count += 1
    meta["best_score"] = 0.75
    threading.Timer(0.2, go.set).start()
    assert writer.join() is True and not _writer_threads()
    assert writer.join() is False                    # nothing left in flight
    fresh, _ = _build(seed=5)
    _, epoch = tck.load_checkpoint(str(tmp_path), fresh)
    got = _tensors(fresh)
    assert epoch == 4 and got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert (fresh.step, fresh.queue_fill, fresh.opt.count) == counters
    assert tck.load_checkpoint_meta(str(tmp_path)) == {"best_score": 0.25}


def test_writer_reuses_its_host_buffers():
    writer = tck.CheckpointWriter()
    a, b = torch.arange(6.0), torch.ones(2, 3, dtype=torch.bfloat16)
    first = writer.to_host({"a": a, "n": 3, "d": {"b": b}})
    a.add_(1)
    second = writer.to_host({"a": a, "n": 4, "d": {"b": b}})
    assert second["n"] == 4 and torch.equal(second["a"], a)
    assert second["a"].data_ptr() == first["a"].data_ptr() != a.data_ptr()
    assert second["d"]["b"].data_ptr() == first["d"]["b"].data_ptr()
    third = writer.to_host({"a": torch.zeros(7)})    # another shape: a new buffer
    assert third["a"].shape == (7,) and third["a"].data_ptr() != first["a"].data_ptr()


def test_writer_failed_write_raises_at_the_next_join(tmp_path, monkeypatch):
    state, _ = _build()
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    go = _hold_writes(monkeypatch)
    writer = tck.CheckpointWriter()
    tck.save_checkpoint(state, str(run_dir), 1, meta={}, writer=writer)
    shutil.rmtree(run_dir)
    go.set()
    with pytest.raises((OSError, RuntimeError)):
        tck.save_checkpoint(state, str(tmp_path), 2, writer=writer)
    assert not _writer_threads() and writer.join() is False
    assert not os.path.exists(tmp_path / "checkpoint.pt")


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
