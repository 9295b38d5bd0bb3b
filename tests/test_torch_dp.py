"""The port's data parallelism (parallel/mesh, core/timet with a data axis,
ops/sinkhorn over a group, models/moco over a group, the loader's shards,
core/train and cli/train over ranks) on the CPU: 2 gloo ranks, spawned
(tests/torch_dp_worker.py, each spawn with its own timeout), against the
JAX package's step shard_mapped over the first 2 of the conftest's 8 CPU
devices, at test width (ViT patch 8, D 32, depth 2, head (48, 24), 8
prototypes, 2 clips of 3 frames a rank, f32, ``attn_impl="xla"``).

Tolerances: the step's losses at rtol 1e-5 and every parameter, teacher leaf
and queue row at rtol 1e-5 / atol 1e-6 (tests/test_torch_timet.py's, with
the key third of a qkv bias held to Adam's step size); the Sinkhorn at the
rtol 1e-5 of tests/test_torch_sinkhorn.py (f32 sums in another order). The
replicated state of the two ranks is compared bit for bit."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

cv2 = pytest.importorskip("cv2")

from test_torch_timet import _assert_leaves_close, _flat  # noqa: E402
from timetuning_tpu.core import optimizer as jopt  # noqa: E402
from timetuning_tpu.core import timet as jt  # noqa: E402
from timetuning_tpu.models.extractor import FeatureExtractor as JFeatureExtractor  # noqa: E402
from timetuning_tpu.models.moco import contrastive_loss as jcontrastive  # noqa: E402
from timetuning_tpu.models.vit import ViTConfig as JViTConfig  # noqa: E402
from timetuning_tpu.models.vit import VisionTransformer as JVisionTransformer  # noqa: E402
from timetuning_tpu.ops.sinkhorn import sinkhorn as jsinkhorn  # noqa: E402
from timetuning_tpu_torch.core import timet as tt  # noqa: E402
from timetuning_tpu_torch.core import train as ttrain  # noqa: E402
from timetuning_tpu_torch.core.optimizer import swav_optimizer  # noqa: E402
from timetuning_tpu_torch.models.convert import (  # noqa: E402
    timet_params_to_jax,
    timet_state_dict_from_jax,
)
from timetuning_tpu_torch.ops.sinkhorn import sinkhorn  # noqa: E402
from torch_dp_worker import HEAD, K, ROOT, SCHED, UNFREEZE, VIT, free_port, spawn, torch_model  # noqa: E402

torch.set_num_threads(2)
WORLD, B_LOCAL, FRAMES, STEPS = 2, 2, 3, 3
N = (VIT["img_size"] // VIT["patch_size"]) ** 2
QUEUE_ROWS = 48          # a rank's FIFO: 20 rows a step, full at the third
TOL = dict(rtol=1e-5, atol=1e-6)

STEP_CASES = {
    # name: (TimeTConfig kwargs, opt_over_trainable, masked)
    "full_tree": (dict(), False, False),
    "queue_subtree": (dict(use_queue=True, queue_size=QUEUE_ROWS), True, True),
}


def mesh2():
    return Mesh(np.array(jax.devices()[:WORLD]), ("data",))


def jax_model():
    fe = JFeatureExtractor(JVisionTransformer(JViTConfig(attn_impl="xla", **VIT)),
                           head_dims=HEAD)
    return jt.TimeT(feature_extractor=fe, n_prototypes=K)


def jax_params():
    return jax_model().init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))["params"]


def clips(n, b, seed=0):
    """Smoothly moving patterns plus noise (as tests/test_torch_timet.py's),
    [n, b, FRAMES, 32, 32, 3]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:32, 0:32] / 32.0
    out = np.empty((n, b, FRAMES, 32, 32, 3), np.float32)
    for i in range(n):
        for c in range(b):
            ph = rng.uniform(0, 2 * np.pi, 3)
            for f in range(FRAMES):
                base = np.stack([np.sin(6 * xx + ph[0] + 0.3 * f),
                                 np.cos(5 * yy + ph[1] - 0.2 * f),
                                 np.sin(4 * (xx + yy) + ph[2])], -1)
                out[i, c, f] = base + 0.3 * rng.standard_normal((32, 32, 3))
    return out


def jax_dp_steps(params, data, rngs, cfg_kw, over, masked, zero1=False):
    """JAX's step shard_mapped over 2 devices: (losses, final state, plan)."""
    model = jax_model()
    cfg = jt.TimeTConfig(n_prototypes=K, spatial_resolution=4, axis_name="data",
                         world_size=WORLD, **SCHED, **cfg_kw)
    kw = dict(lr=1e-3, unfreeze_layers=UNFREEZE, **SCHED)
    plan = None
    if zero1:
        tx, mask, plan = jopt.swav_optimizer_zero1(params, world_size=WORLD, **kw)
    else:
        tx, mask = jopt.swav_optimizer(params, opt_over_trainable=over, **kw)
    state = jt.init_state(model, cfg, tx, jax.random.PRNGKey(0), None, params=params,
                          trainable_mask=mask if over else None, zero1_plan=plan)
    step = jt.make_train_step(model, cfg, tx, trainable_mask=mask if masked else None,
                              opt_over_trainable=over, zero1_plan=plan)
    specs = jt.state_partition_specs(state, "data",
                                     zero1_padded=plan.padded if plan else None)
    f = jax.jit(jax.shard_map(step, mesh=mesh2(), in_specs=(specs, P("data"), P()),
                              out_specs=(specs, P())))
    losses = []
    for clip, rng in zip(data, rngs):
        state, m = f(state, jnp.asarray(clip), rng)
        losses.append(float(m["loss"]))
    return losses, state, plan


def queue_draws(rngs, n_store):
    """The indices JAX's step draws for the queue: under shard_map every
    device takes the same step key, so both ranks draw the same."""
    return [np.asarray(jax.random.permutation(r, B_LOCAL * N)[:n_store]) for r in rngs]


def assert_state_matches_jax(got: dict, jstate, use_teacher=True):
    _assert_leaves_close(_flat(timet_params_to_jax(got["params"])), _flat(jstate.params))
    if use_teacher:
        teacher = {**got["params"], **got["teacher"]}
        _assert_leaves_close(_flat(timet_params_to_jax(teacher)),
                             _flat(jstate.teacher_params))


def assert_replicas_identical(ranks: list[dict], key="replicated"):
    a, b = ranks[0][key], ranks[1][key]
    assert a.keys() == b.keys() and len(a) > 0
    for k in a:
        assert torch.equal(a[k], b[k]), k


def scores(B, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (B, K)).astype(np.float32)


def sinkhorn_inputs():
    """Global [2 x 24, K] scores: plain; with a validity mask; with an
    underflowed prototype column and masked columns on both ranks."""
    s = scores(2 * 24, 3)
    v = (np.random.default_rng(4).uniform(size=48) > 0.3).astype(np.float32)
    v[0] = v[24] = 1.0
    pinned = s.copy()
    pinned[:, 2] = -100.0                      # exp(-100 / 0.05) == 0 in f32
    return {"plain": (s, None), "valid": (s, v), "pinned": (pinned, v)}


def write_davis(root, n_videos=4, frames=6):
    for v in range(n_videos):
        fdir = os.path.join(root, "JPEGImages", "480p", f"video{v}")
        adir = os.path.join(root, "Annotations", "480p", f"video{v}")
        os.makedirs(fdir)
        os.makedirs(adir)
        for f in range(frames):
            img = np.full((48, 48, 3), 30, np.uint8)
            y = 8 + f + 2 * v
            img[y:y + 16, 12:32] = [220, 40 + 30 * v, 40]
            cv2.imwrite(os.path.join(fdir, f"{f:05d}.jpg"), img)
            ann = np.zeros((48, 48), np.uint8)
            ann[y:y + 16, 12:32] = 1
            cv2.imwrite(os.path.join(adir, f"{f:05d}.png"), ann)
    return root


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX references and one 2-rank run of every step, Sinkhorn,
    contrastive and loader case."""
    params = jax_params()
    sd = timet_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    data = clips(STEPS, WORLD * B_LOCAL)
    rngs = list(jax.random.split(jax.random.PRNGKey(7), STEPS))
    root = write_davis(str(tmp_path_factory.mktemp("davis_dp")))
    job = []
    for name, (cfg_kw, over, masked) in STEP_CASES.items():
        draws = (queue_draws(rngs, min(B_LOCAL * 10, QUEUE_ROWS))
                 if cfg_kw.get("use_queue") else None)
        job.append(dict(kind="step", name=name, state_dict=sd, cfg=cfg_kw,
                        opt_over_trainable=over, clips=data, draws=draws))
    q = np.random.default_rng(5).standard_normal((2 * 6, 16)).astype(np.float32)
    k = np.random.default_rng(6).standard_normal((2 * 6, 16)).astype(np.float32)
    job += [dict(kind="sinkhorn", name="sinkhorn", inputs=sinkhorn_inputs()),
            dict(kind="contrastive", name="contrastive", q=q, k=k),
            dict(kind="loader", name="loader", root=root)]
    ranks = spawn(job, str(tmp_path_factory.mktemp("dp_ranks")), WORLD, timeout=240)
    return dict(params=params, sd=sd, data=data, rngs=rngs, ranks=ranks, q=q, k=k,
                root=root)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_dp_step_matches_jax_shard_map(setup, name):
    cfg_kw, over, masked = STEP_CASES[name]
    jl, jstate, _ = jax_dp_steps(setup["params"], setup["data"], setup["rngs"],
                                 cfg_kw, over, masked)
    for r, got in enumerate(setup["ranks"]):
        got = got[name]
        np.testing.assert_allclose(got["losses"], jl, rtol=1e-5)
        assert_state_matches_jax(got, jstate)
        if cfg_kw.get("use_queue"):
            assert got["queue_fill"] == int(jstate.queue_fill) == QUEUE_ROWS
            shard = np.asarray(jstate.queue)[r * QUEUE_ROWS:(r + 1) * QUEUE_ROWS]
            np.testing.assert_allclose(got["queue"].numpy(), shard, **TOL)
            assert got["partition"]["queue"] == "per_rank"
    assert setup["ranks"][0][name]["losses"][0] != setup["ranks"][0][name]["losses"][-1]


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_replicated_state_is_bit_identical_across_ranks(setup, name):
    assert_replicas_identical([r[name] for r in setup["ranks"]])
    if STEP_CASES[name][0].get("use_queue"):       # the queues are the ranks' own
        assert not torch.equal(setup["ranks"][0][name]["queue"],
                               setup["ranks"][1][name]["queue"])


def test_dp_matches_single_process_on_the_concatenated_batch(setup):
    """The 2-rank step (no queue) against the port's one-process step on the
    4-clip batch: the global Sinkhorn and the mean over ranks make them the
    same step (tests/test_train_step.py:120's, here at the port's f32
    tolerance)."""
    model = torch_model(setup["sd"])
    cfg = tt.TimeTConfig(n_prototypes=K, spatial_resolution=4, **SCHED)
    opt, mask = swav_optimizer(model, lr=1e-3, unfreeze_layers=UNFREEZE, **SCHED)
    state = tt.init_state(model, cfg, opt)
    step = tt.make_train_step(model, cfg, opt)
    losses = []
    for clip in setup["data"]:
        state, m = step(state, torch.from_numpy(clip), None)
        losses.append(float(m["loss"]))
    got = setup["ranks"][0]["full_tree"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    _assert_leaves_close(_flat(timet_params_to_jax(got["params"])),
                         _flat(timet_params_to_jax(model.state_dict())))


def test_group_sinkhorn_matches_jax_psum_and_the_global_sinkhorn(setup):
    """Each rank's plain group Sinkhorn (the matvec form, 10 iterations)
    against JAX's psum form shard_mapped over 2 devices, and the two ranks
    together against the one-process Sinkhorn of the concatenated scores."""
    got = setup["ranks"]
    for key, (s, v) in sinkhorn_inputs().items():
        Q = np.exp(s / 0.05).T.astype(np.float32)
        if v is None:
            f = jax.shard_map(lambda q: jsinkhorn(q, 10, "data", WORLD), mesh=mesh2(),
                              in_specs=P(None, "data"), out_specs=P("data"))
            want = np.asarray(jax.jit(f)(jnp.asarray(Q)))
        else:
            f = jax.shard_map(lambda q, m: jsinkhorn(q, 10, "data", WORLD, m),
                              mesh=mesh2(), in_specs=(P(None, "data"), P("data")),
                              out_specs=P("data"))
            want = np.asarray(jax.jit(f)(jnp.asarray(Q), jnp.asarray(v)))
        both = np.concatenate([got[0]["sinkhorn"][key].numpy(),
                               got[1]["sinkhorn"][key].numpy()])
        assert np.isfinite(both).all()
        np.testing.assert_allclose(both, want, rtol=1e-5, atol=1e-9)
        single = sinkhorn(torch.from_numpy(Q), 10,
                          valid=None if v is None else torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(both, single, rtol=1e-5, atol=1e-9)
        if key == "pinned":
            assert np.all(both[:, 2] == 0) and np.all(both[v == 0] == 0)


def test_contrastive_loss_over_the_group_matches_jax_all_gather(setup):
    q, k = setup["q"], setup["k"]
    f = jax.shard_map(lambda a, b: jcontrastive(a, b, 0.2, axis_name="data")[None],
                      mesh=mesh2(), in_specs=(P("data"), P("data")), out_specs=P("data"))
    want = np.asarray(jax.jit(f)(jnp.asarray(q), jnp.asarray(k)))
    got = [r["contrastive"]["loss"] for r in setup["ranks"]]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert all(r["contrastive"]["grad_finite"] for r in setup["ranks"])


def test_loader_shards_and_host_batch_over_two_ranks(setup):
    """Each rank's loader yields an equal count of distinct clips, together
    the epoch's (tests/test_multihost.py:599's counterpart), and
    ``host_batch_to_device`` puts a rank's own batch on its device whole;
    ``shard_batch`` takes a rank's rows of a global batch."""
    a, b = (r["loader"] for r in setup["ranks"])
    assert a["len"] == b["len"] == 2 and len(a["batches"]) == len(b["batches"]) == 2
    seen = [x for r in (a, b) for x in r["batches"]]
    assert all(x.shape == seen[0].shape and x.dtype == torch.uint8 for x in seen)
    keys = {x.numpy().tobytes() for x in seen}
    assert len(keys) == 4                       # four videos, none twice
    glob = np.arange(WORLD * 6).reshape(WORLD * 3, 2)
    assert np.array_equal(a["shard"].numpy(), glob[:3])
    assert np.array_equal(b["shard"].numpy(), glob[3:])
    assert not any(r["foreign_modules"] for r in setup["ranks"])


def _driver_cfg(root, log_dir, **kw):
    base = dict(architecture="vit-tiny-test", dataset="davis", data_root=root,
                log_dir=log_dir, batch_size=1, num_epochs=2, num_workers=0,
                num_frames=3, num_clusters=8, input_resolution=32, n_last_frames=2,
                size_mask_neighborhood=1, compute_dtype="float32",
                unfreeze_layers=("blocks.1",), use_tensorboard=False,
                decode_size=48, head_dims=(16, 8), use_queue=True, queue_size=64,
                device="cpu")
    return base | kw


def test_run_training_over_two_ranks_then_resume_at_one(setup, tmp_path):
    """``run_training`` at 2 ranks (2 steps an epoch on each): rank 0 alone
    chooses and writes the run directory, the meta says world 2 and 32 queue
    rows a rank, the replicated state agrees bit for bit; a run where rank 1
    alone gets SIGTERM stops on both ranks at the same step with one
    checkpoint (tests/test_multihost.py:548's counterpart); a resume of the
    first run at world 1 resets the queue with the warning and trains on."""
    logs, plogs = str(tmp_path / "logs"), str(tmp_path / "plogs")
    job = [dict(kind="driver", name="run", cfg=_driver_cfg(setup["root"], logs)),
           dict(kind="driver", name="preempt", sigterm_at=1,
                cfg=_driver_cfg(setup["root"], plogs, num_epochs=3))]
    r0, r1 = spawn(job, str(tmp_path / "ranks"), WORLD, timeout=240)
    run_dir = r0["run"]["run_dir"]
    assert r1["run"]["run_dir"] == run_dir and len(os.listdir(logs)) == 1
    assert r0["run"]["global_step"] == r1["run"]["global_step"] == 4
    assert_replicas_identical([r0["run"], r1["run"]])
    files = set(os.listdir(run_dir))
    assert {"checkpoint.pt", "checkpoint_meta.json", "metrics.jsonl", "train.log",
            "config.txt"} <= files
    meta = json.load(open(os.path.join(run_dir, "checkpoint_meta.json")))
    assert meta["world_size"] == 2 and meta["queue_rows_per_device"] == 32
    rows = [json.loads(x) for x in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert [x["step"] for x in rows if x["tag"] == "Loss/train"] == [1, 2, 3, 4]
    saved = torch.load(os.path.join(run_dir, "checkpoint.pt"), weights_only=True)
    assert saved["queue"].shape[0] == 64 and saved["step"] == 4

    p0, p1 = r0["preempt"], r1["preempt"]
    assert p0["preempted"] and p1["preempted"]
    assert p0["global_step"] == p1["global_step"] == p0["step"] == 1
    pdir = p0["run_dir"]
    assert torch.load(os.path.join(pdir, "checkpoint.pt"), weights_only=True)["step"] == 1

    cfg = ttrain.TrainingConfig(**_driver_cfg(setup["root"], logs, num_epochs=3,
                                              load_checkpoint=True))
    r = ttrain.run_training(cfg)
    assert r["run_dir"] == run_dir and r["global_step"] == 8   # 4 videos, 1 rank
    assert "feature queue reset on restore" in open(os.path.join(run_dir, "train.log")).read()
    assert r["state"].queue.shape[0] == 64 and np.isfinite(r["final_loss"])


def test_cli_train_multihost_on_two_cpu_ranks(setup, tmp_path):
    """``cli/train --multihost true --device cpu`` under a 2-rank launch with
    torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT): both ranks print the same run directory."""
    port = free_port()
    argv = [sys.executable, "-m", "timetuning_tpu_torch.cli.train", "--multihost", "true",
            "--device", "cpu", "--architecture", "vit-tiny-test", "--dataset", "davis",
            "--data_root", setup["root"], "--log_dir", str(tmp_path), "--batch_size", "1",
            "--num_epochs", "1", "--num_frames", "3", "--num_workers", "0",
            "--num_clusters", "8", "--input_resolution", "32", "--n_last_frames", "2",
            "--size_mask_neighborhood", "1", "--compute_dtype", "float32",
            "--unfreeze_layers", "blocks.1", "--zero1", "true"]
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", RANK=str(r),
                   LOCAL_RANK=str(r), WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), TORCH_DIST_INIT_BARRIER="1")
        procs.append(subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    dirs = [next(x for x in out.splitlines() if x.startswith("done: run_dir="))
            .split()[1] for out in outs]
    assert dirs[0] == dirs[1]
    meta = json.load(open(os.path.join(dirs[0].split("=", 1)[1], "checkpoint_meta.json")))
    assert meta["world_size"] == 2 and meta["opt_layout"] == "zero1"
