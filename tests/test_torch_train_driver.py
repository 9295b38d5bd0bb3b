"""The port's training driver (core/train.py, cli/train.py) on the CPU.

* ``make_full_step``: 3 steps of uint8 batch -> augmentation -> TimeT step
  against the JAX ``make_full_step`` (``mesh=None``, f32) from the same
  weights on the same batches, the augmentation's and the queue's draws
  taken from JAX's keys (mirrored): every loss, parameter, teacher leaf and
  queue row at the tolerance of tests/test_torch_timet.py (rtol 1e-5, atol
  1e-6; the key third of a qkv bias held to Adam's step size, as there).
* ``run_training`` on a synthetic DAVIS tree with ``device="cpu"``: metrics,
  config and checkpoint written; a resume at the saved epoch; a run stopped
  by SIGTERM mid-epoch and resumed equals the uninterrupted run bit for bit
  (losses, parameters, teacher, AdamW moments, queue); with a VOC tree it
  evaluates and exports the best ``.pth``; with a stub step whose loss is a
  function of the step number, every step logs its own loss.
* the multi-device options and ``cli/train`` without a card raise.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from test_torch_augment import jax_params  # noqa: E402
from test_torch_timet import (  # noqa: E402
    K,
    UNFREEZE,
    _assert_leaves_close,
    _flat,
    _jax_model,
    _torch_model,
)
from timetuning_tpu.core import optimizer as jopt  # noqa: E402
from timetuning_tpu.core import timet as jt  # noqa: E402
from timetuning_tpu.core import train as jtrain  # noqa: E402
from timetuning_tpu.data import transforms as jtf  # noqa: E402
from timetuning_tpu_torch.cli import train as tcli  # noqa: E402
from timetuning_tpu_torch.core import timet as tt  # noqa: E402
from timetuning_tpu_torch.core import train as ttrain  # noqa: E402
from timetuning_tpu_torch.core.optimizer import swav_optimizer  # noqa: E402
from timetuning_tpu_torch.data import transforms as ttf  # noqa: E402
from timetuning_tpu_torch.models.convert import (  # noqa: E402
    timet_params_to_jax,
    timet_state_dict_from_jax,
)

torch.set_num_threads(2)
B, F, STEPS, BUF = 2, 3, 3, 40


def _u8_batches(n, seed=0):
    """uint8 decode buffers with structure (smooth moving patterns, so the
    propagation's argmax is not decided by rounding), native sizes and gray
    means."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:BUF, 0:BUF] / BUF
    out = np.empty((n, B, F, BUF, BUF, 3), np.uint8)
    for i in range(n):
        for b in range(B):
            ph = rng.uniform(0, 2 * np.pi, 3)
            for f in range(F):
                base = np.stack([np.sin(6 * xx + ph[0] + 0.3 * f),
                                 np.cos(5 * yy + ph[1] - 0.2 * f),
                                 np.sin(4 * (xx + yy) + ph[2])], -1)
                out[i, b, f] = np.clip(127.5 + 110 * base, 0, 255).astype(np.uint8)
    sizes = np.array([[48, 64], [60, 40]], np.int32)
    gmeans = rng.uniform(60, 200, (n, B, F)).astype(np.float32)
    return out, sizes, gmeans


def test_full_step_matches_jax(monkeypatch):
    jmodel = _jax_model()
    params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))["params"]
    # host copies: the jitted JAX step donates (and deletes) the state's arrays
    start = timet_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    sched = dict(num_epochs=1, steps_per_epoch=10)
    cfg_kw = dict(frozen_trunk_blocks=1, use_queue=True, queue_size=40)
    frames, sizes, gmeans = _u8_batches(STEPS)
    keys = jax.random.split(jax.random.PRNGKey(7), STEPS)
    aug = jtf.AugmentConfig(out_size=32)

    jcfg = jt.TimeTConfig(n_prototypes=K, spatial_resolution=4, **sched, **cfg_kw)
    tx, jmask = jopt.swav_optimizer(params, lr=1e-3, unfreeze_layers=UNFREEZE,
                                    opt_over_trainable=True, **sched)
    jstate = jt.init_state(jmodel, jcfg, tx, jax.random.PRNGKey(0), None,
                           params=params, trainable_mask=jmask)
    jstep = jtrain.make_full_step(jmodel, jcfg, tx, aug, mesh=None,
                                  trainable_mask=jmask, opt_over_trainable=True)
    jlosses = []
    for i in range(STEPS):
        jstate, m = jstep(jstate, jnp.asarray(frames[i]), jnp.asarray(sizes),
                          jnp.asarray(gmeans[i]), keys[i])
        jlosses.append(float(m["loss"]))

    # the port, on the values JAX's keys drew: the augmentation from k_aug,
    # the queue's choice from k_step
    splits = [jax.random.split(k) for k in keys]
    drawn = iter([np.asarray(jax.random.permutation(ks, B * 16)[:20]) for _, ks in splits])
    monkeypatch.setattr(tt, "queue_store_indices",
                        lambda n, k, g: torch.from_numpy(next(drawn).astype(np.int64)))
    tmodel = _torch_model()
    tmodel.load_state_dict(start)
    tcfg = tt.TimeTConfig(n_prototypes=K, spatial_resolution=4, **sched, **cfg_kw)
    opt, tmask = swav_optimizer(tmodel, lr=1e-3, unfreeze_layers=UNFREEZE,
                                opt_over_trainable=True, **sched)
    tstate = tt.init_state(tmodel, tcfg, opt, trainable_mask=tmask)
    tstep = ttrain.make_full_step(tmodel, tcfg, opt, ttf.AugmentConfig(out_size=32),
                                  trainable_mask=tmask, opt_over_trainable=True)
    aug_drawn = iter([jax_params(k_aug, B, F, jtf.AugmentConfig()) for k_aug, _ in splits])
    monkeypatch.setattr(ttrain, "draw_augment_params", lambda g, b, f, cfg: next(aug_drawn))
    tlosses = []
    for i in range(STEPS):
        tstate, m = tstep(tstate, torch.from_numpy(frames[i]), torch.from_numpy(sizes),
                          torch.from_numpy(gmeans[i]), None)
        tlosses.append(float(m["loss"]))

    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[0] != tlosses[-1]
    _assert_leaves_close(_flat(timet_params_to_jax(tmodel.state_dict())),
                         _flat(jstate.params))
    teacher = {**tmodel.state_dict(), **tstate.teacher}
    _assert_leaves_close(_flat(timet_params_to_jax(teacher)), _flat(jstate.teacher_params))
    assert tstate.queue_fill == int(jstate.queue_fill) == 40
    # rows of order 1 from parameters that agree to 1e-5, as in test_torch_timet
    np.testing.assert_allclose(tstate.queue.numpy(), np.asarray(jstate.queue),
                               rtol=1e-5, atol=1e-5)
    assert tstate.step == int(jstate.step) == STEPS


def test_step_generator_is_a_function_of_seed_and_step():
    a = ttrain.step_generator(1, 5)
    b = ttrain.step_generator(1, 5)
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    c = torch.rand(4, generator=ttrain.step_generator(1, 6))
    assert not torch.equal(torch.rand(4, generator=ttrain.step_generator(1, 5)), c)


# ------------------------------------------------------------------ #
# run_training on synthetic trees

@pytest.fixture(scope="module")
def davis_tree(tmp_path_factory):
    """tests/test_training_e2e.py's tree: 4 videos of 6 random 48x64 frames."""
    root = tmp_path_factory.mktemp("davis_driver")
    rng = np.random.default_rng(0)
    for v in range(4):
        fdir = root / "JPEGImages" / "480p" / f"video{v}"
        fdir.mkdir(parents=True)
        for f in range(6):
            cv2.imwrite(str(fdir / f"{f:05d}.jpg"),
                        rng.integers(0, 255, size=(48, 64, 3), dtype=np.uint8))
    return str(root)


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc_driver")
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
        for sub in ("SegmentationClass", "SegmentationClassAug"):
            cv2.imwrite(str(root / sub / f"{n}.png"), mask)
    (root / "sets" / "val.txt").write_text("\n".join(names[:3]))
    (root / "sets" / "trainaug.txt").write_text("\n".join(names[3:]))
    return str(root)


def _cfg(davis_tree, log_dir, **kw):
    base = dict(
        architecture="vit-tiny-test", dataset="davis", data_root=davis_tree,
        log_dir=str(log_dir), batch_size=2, num_epochs=2, num_frames=3,
        num_workers=2, num_clusters=8, input_resolution=32, n_last_frames=2,
        size_mask_neighborhood=1, decode_size=48, head_dims=(16, 8),
        unfreeze_layers=("blocks.1",), compute_dtype="float32", use_queue=True,
        queue_size=16, max_steps_per_epoch=2, use_tensorboard=False, device="cpu")
    base.update(kw)
    return ttrain.TrainingConfig(**base)


def _losses(run_dir):
    rows = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    return {r["step"]: r["value"] for r in rows if r["tag"] == "Loss/train"}


@pytest.fixture(scope="module")
def uninterrupted(davis_tree, tmp_path_factory):
    return ttrain.run_training(_cfg(davis_tree, tmp_path_factory.mktemp("straight")))


def test_training_runs_and_checkpoints(uninterrupted):
    r = uninterrupted
    assert r["global_step"] == 4 and np.isfinite(r["final_loss"])
    run_dir = r["run_dir"]
    for name in ("checkpoint.pt", "checkpoint_meta.json", "config.txt", "train.log"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    tags = {json.loads(line)["tag"] for line in open(os.path.join(run_dir, "metrics.jsonl"))}
    assert {"Loss/train", "momentum"} <= tags
    assert sorted(_losses(run_dir)) == [1, 2, 3, 4]        # logged one step late
    meta = json.load(open(os.path.join(run_dir, "checkpoint_meta.json")))
    assert meta["steps_per_epoch"] == 2 and meta["queue_rows_per_device"] == 16
    assert r["state"].queue_fill == 16


def _state_tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"teacher.{k}": v for k, v in state.teacher.items()})
    for n, p in state.opt.named_params.items():
        for k, v in state.opt.adamw.state.get(p, {}).items():
            out[f"adam.{n}.{k}"] = v
    out["queue"] = state.queue
    return out


def test_resume_after_sigterm_equals_uninterrupted_run(davis_tree, tmp_path,
                                                       monkeypatch, uninterrupted):
    """SIGTERM raised from the mid-epoch save at step 3 (epoch 1 of 2) stops
    the run there; the resumed run skips the batch epoch 1 already trained
    and ends bit for bit where the uninterrupted run ended."""
    orig_save = ttrain.save_checkpoint

    def spy(state, run_dir, epoch, meta=None, **kw):
        path = orig_save(state, run_dir, epoch, meta=meta, **kw)
        if state.step == 3:
            signal.raise_signal(signal.SIGTERM)
        return path

    monkeypatch.setattr(ttrain, "save_checkpoint", spy)
    r1 = ttrain.run_training(_cfg(davis_tree, tmp_path, checkpoint_every_steps=3))
    monkeypatch.setattr(ttrain, "save_checkpoint", orig_save)
    assert r1["preempted"] is True and r1["global_step"] == 3
    r2 = ttrain.run_training(_cfg(davis_tree, tmp_path, load_checkpoint=True))
    assert r2["run_dir"] == r1["run_dir"] and r2["global_step"] == 4
    assert r2["preempted"] is False
    la, lb = _losses(uninterrupted["run_dir"]), _losses(r2["run_dir"])
    assert la == lb, (la, lb)
    want, got = _state_tensors(uninterrupted["state"]), _state_tensors(r2["state"])
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    assert r2["state"].queue_fill == uninterrupted["state"].queue_fill


def _stub_loss(n):
    return 1.0 + n / 8


@pytest.mark.parametrize("sigterm_at", [None, 2, 3])
def test_each_step_logs_its_own_loss(davis_tree, tmp_path, monkeypatch, sigterm_at):
    """With a step whose loss is a function of its number, ``run_training``
    logs step n's loss at step n, one step late: mid-epoch, at each epoch's
    last step, and on the preemption path (SIGTERM at an epoch's last step,
    after the loop's own read, and at the next epoch's first); the final
    loss is the last step's. The losses are CPU tensors, which read as their
    float with no copy and no event."""
    def make(*_a, **_kw):
        def step(state, frames, sizes, gmeans, generator):
            state.step += 1
            if state.step == sigterm_at:
                signal.raise_signal(signal.SIGTERM)
            return state, {"loss": torch.tensor(_stub_loss(state.step)), "momentum": 0.5}
        return step

    loss = torch.tensor(0.75)
    value, ready = ttrain.queue_loss_copy(loss)
    assert value is loss and ready is None and ttrain.read_queued_loss(value, ready) == 0.75
    monkeypatch.setattr(ttrain, "make_full_step", make)
    r = ttrain.run_training(_cfg(davis_tree, tmp_path))
    last = sigterm_at or 4
    assert r["global_step"] == last and r["preempted"] is (sigterm_at is not None)
    assert _losses(r["run_dir"]) == {n: _stub_loss(n) for n in range(1, last + 1)}
    assert r["final_loss"] == _stub_loss(last)


def test_resume_at_the_saved_epoch(davis_tree, tmp_path, uninterrupted):
    r = ttrain.run_training(_cfg(davis_tree, tmp_path / "a", num_epochs=1))
    r2 = ttrain.run_training(_cfg(davis_tree, tmp_path / "a", num_epochs=2,
                                  load_checkpoint=True))
    # the final save marks epoch 1 trained: the resumed run trains epoch 1 only
    assert r2["run_dir"] == r["run_dir"] and r2["global_step"] == 4
    assert set(_losses(r2["run_dir"])) == {1, 2, 3, 4}


def test_training_with_pascal_eval_exports_best(davis_tree, voc_tree, tmp_path):
    r = ttrain.run_training(_cfg(davis_tree, tmp_path, pascal_root=voc_tree,
                                 eval_every=1, eval_resolution=16,
                                 eval_num_clusters=2, num_epochs=2,
                                 log_histograms=True))
    assert r["last_eval"] is not None and 0.0 <= r["last_eval"] <= 1.0
    rows = [json.loads(line) for line in open(os.path.join(r["run_dir"], "metrics.jsonl"))]
    assert [x["step"] for x in rows if x["tag"] == "Scores/localization"] == [0, 1]
    exports = sorted(f for f in os.listdir(r["run_dir"]) if f.endswith(".pth"))
    assert exports and exports[-1] == f"{r['best_score']:.4f}_" + exports[-1].split("_")[-1]
    sd = torch.load(os.path.join(r["run_dir"], exports[0]), weights_only=True)
    assert "prototypes" in sd and "feature_extractor.head.2.weight" in sd
    meta = json.load(open(os.path.join(r["run_dir"], "checkpoint_meta.json")))
    assert meta["best_score"] == r["best_score"]
    # the diagnostics of each eval epoch: entropy, histogram, overlay gif
    assert [x["step"] for x in rows if x["tag"] == "Scores/entropy"] == [0, 1]
    assert os.path.exists(os.path.join(r["run_dir"], "artifacts", "assignments_epoch1.gif"))


@pytest.mark.parametrize("kw,flag", [
    (dict(num_devices=2), "num_devices"),
    (dict(zero1=True), "zero1"),
    (dict(tensor_parallel=2), "tensor_parallel"),
])
def test_multi_device_options_raise(davis_tree, tmp_path, kw, flag):
    """In one process: ``num_devices`` other than the ranks that run is
    refused (a process a device); ``zero1`` is disabled with a warning and
    the run trains in the subtree layout (JAX's behaviour on one device);
    ``tensor_parallel=2`` is refused at one rank, as JAX refuses it on one
    device. (2 ranks: tests/test_torch_dp.py; tensor_parallel=2 trains at 2
    ranks in tests/test_torch_tp.py's spawn.)"""
    if flag == "zero1":
        r = ttrain.run_training(_cfg(davis_tree, tmp_path, num_epochs=1, **kw))
        assert np.isfinite(r["final_loss"])
        assert "zero1 requested but disabled" in open(
            os.path.join(r["run_dir"], "train.log")).read()
        meta = json.load(open(os.path.join(r["run_dir"], "checkpoint_meta.json")))
        assert meta["opt_layout"] == "trainable-subtree" and meta["world_size"] == 1
        return
    err, match = {"num_devices": (ValueError, "num_devices=2 but 1 process"),
                  "tensor_parallel": (ValueError,
                                      "tensor_parallel=2 must divide the 1 devices")}[flag]
    with pytest.raises(err, match=match):
        ttrain.run_training(_cfg(davis_tree, tmp_path, **kw))


def test_cli_multihost_raises_and_no_card_raises(davis_tree, tmp_path, monkeypatch, capsys):
    """``--multihost true`` initializes the group from torchrun's environment
    (here one rank: RANK 0, WORLD_SIZE 1; 2 ranks: tests/test_torch_dp.py),
    trains and takes the group down; without a card and without
    ``--device cpu`` the CLI and the driver raise."""
    import torch.distributed as dist
    from torch_dp_worker import free_port

    argv = ["--architecture", "vit-tiny-test", "--dataset", "davis", "--data_root",
            davis_tree, "--log_dir", str(tmp_path)]
    for k, v in dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                     MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(k, v)
    assert tcli.main(argv + ["--multihost", "true", "--device", "cpu", "--batch_size", "2",
                             "--num_epochs", "1", "--num_frames", "3", "--num_workers", "0",
                             "--num_clusters", "8", "--input_resolution", "32",
                             "--n_last_frames", "2", "--size_mask_neighborhood", "1",
                             "--compute_dtype", "float32",
                             "--unfreeze_layers", "blocks.1"]) == 0
    assert "done: run_dir=" in capsys.readouterr().out
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device found"):
        tcli.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device found"):
        ttrain.run_training(_cfg(davis_tree, tmp_path, device=None))


def test_cli_flags_are_the_jax_clis(davis_tree, tmp_path, capsys):
    from timetuning_tpu.cli import train as jcli

    def flags(parser):
        return {a.dest: a.default for a in parser._actions if a.option_strings}

    j, t = flags(jcli.build_parser()), flags(tcli.build_parser())
    assert set(t) - set(j) == {"device"} and set(j) <= set(t)
    assert all(t[k] == j[k] for k in j), [k for k in j if t[k] != j[k]]
    assert len(j) - 1 == 47                           # without --help
    rc = tcli.main(["--architecture", "vit-tiny-test", "--dataset", "davis",
                    "--data_root", davis_tree, "--log_dir", str(tmp_path),
                    "--batch_size", "2", "--num_epochs", "1", "--num_frames", "3",
                    "--num_workers", "2", "--num_clusters", "8",
                    "--input_resolution", "32", "--n_last_frames", "2",
                    "--size_mask_neighborhood", "1", "--compute_dtype", "float32",
                    "--unfreeze_layers", "blocks.1", "--device", "cpu"])
    assert rc == 0 and "done: run_dir=" in capsys.readouterr().out


def test_training_spans_under_a_trace(davis_tree, tmp_path):
    """``run_training`` under ``obs/profiling.trace``: the driver's, the
    loader's and the checkpoint's spans, nested as the loop runs them, the
    decodes on the loader's threads, and ``spans.jsonl`` beside the trace."""
    import threading

    from timetuning_tpu_torch.obs import profiling

    profiling.clear()
    with profiling.trace(str(tmp_path / "prof")):
        r = ttrain.run_training(_cfg(davis_tree, tmp_path / "run", num_epochs=1))
    spans = profiling.spans()
    profiling.clear()
    assert r["global_step"] == 2
    by_id = {s.id: s for s in spans}

    def named(name):
        return [s for s in spans if s.name == name]

    def parents(name):
        return {by_id[s.parent].name if s.parent else None for s in named(name)}

    main = threading.main_thread().ident
    (epoch,) = named("train.epoch")
    assert epoch.attrs == {"epoch": 0} and epoch.parent == 0 and epoch.thread == main
    assert len(named("train.step")) == 2 and parents("train.step") == {"train.epoch"}
    assert len(named("loader.stage")) >= 2 and parents("loader.stage") == {"train.epoch"}
    assert len(named("train.log")) == 2 and parents("train.log") == {"train.epoch"}
    assert len(named("train.loss_read")) == 2 and parents("train.loss_read") == {"train.log"}
    # ``queued``: the next step's copy still pending when the read ended;
    # never on the epoch's last read (no next step), nor on the CPU
    queued = {by_id[s.parent].attrs["step"]: s.attrs["queued"] for s in named("train.loss_read")}
    assert queued == {1: False, 2: False} and all(type(q) is bool for q in queued.values())
    # the epoch-top save inside the epoch, the closing one after the loop
    assert len(named("train.save")) == 2 and parents("train.save") == {"train.epoch", None}
    assert len(named("save.gather")) == 2 and parents("save.gather") == {"train.save"}
    assert len(named("save.write")) == 2 and parents("save.write") == {"train.save"}
    assert parents("loader.wait") <= {"train.epoch"}
    decodes = named("loader.decode")
    assert len(decodes) >= 2 and all(s.thread != main for s in decodes)
    for s in spans:
        if s.parent:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns and p.thread == s.thread
    lines = [json.loads(x) for x in open(tmp_path / "prof" / "spans.jsonl")]
    assert sorted(x["id"] for x in lines) == sorted(by_id)


def test_histograms_profiling_and_debug_nans(tmp_path):
    """``obs/histograms`` against the JAX package's on the same scores;
    ``obs/profiling.trace`` writes a trace; ``enable_debug_nans`` switches
    autograd's anomaly mode."""
    from timetuning_tpu.obs import histograms as jh
    from timetuning_tpu_torch import runtime
    from timetuning_tpu_torch.obs import histograms as th
    from timetuning_tpu_torch.obs import profiling

    scores = np.random.default_rng(0).standard_normal((3, 7, 5)).astype(np.float32)
    want = np.asarray(jh.assignment_histogram(jnp.asarray(scores), 6))
    got = th.assignment_histogram(torch.from_numpy(scores), 6).numpy()
    np.testing.assert_array_equal(got, want)
    assert th.assignment_entropy(got) == jh.assignment_entropy(want)
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("region"):
            torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    runtime.enable_debug_nans(True)
    assert torch.is_anomaly_enabled()
    runtime.enable_debug_nans(False)
    assert not torch.is_anomaly_enabled()
