"""The port's tensor parallelism (parallel/tp on a (data, model) mesh, the
Megatron blocks of models/vit, the train step on the mesh, the checkpoint's
whole layout, core/train and cli/train with ``tensor_parallel``) on the CPU.
4 gloo ranks in one spawn (tests/torch_dp_worker.py) run a ``dp 2 x tp 2``
and a ``dp 1 x tp 2`` mesh (ranks 2 and 3 idle in the second), held to
JAX's SINGLE-DEVICE forward and step on the concatenated batch
(tests/test_tensor_parallel.py:167-199 holds JAX's GSPMD step to the same,
so no GSPMD program is compiled here), at test width: a dense ViT of patch
8, D 32, depth 4, 2 heads (one a rank), f32, 4 clips of 3 frames a step,
the queue on (96 rows, full at the third step), blocks 2 and 3 + head +
prototypes trainable. A third ``dp 2 x tp 2`` case trains with
``mask_features`` (the last block's probabilities gathered over the model
axis), held to JAX's first loss and to the port's one-process step. Then 2
ranks run ``cli/train --multihost true --tensor_parallel 2`` for an epoch
and a resumed one, and one process resumes its checkpoint.

Tolerances: tests/test_torch_timet.py's (loss rtol 1e-5; every gathered
leaf and the teacher rtol 1e-5 / atol 1e-6); the tokens, the attention
probabilities and the queue (the teacher's head features) at atol 1e-5: the
row-parallel products sum their halves in another order. Replicated state
is compared bit for bit across all the ranks of a mesh, sharded state
across the ranks of a data axis; a checkpoint through TP and back bit for
bit."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_moe import (
    STEPS,
    UNFREEZE,
    VIT_DENSE,
    N,
    SCHED,
    assert_matches_jax_state,
    clips,
    jax_params,
    jax_steps,
    queue_draws,
)
from timetuning_tpu.models.vit import ViTConfig as JViTConfig
from timetuning_tpu.models.vit import VisionTransformer as JVisionTransformer
from timetuning_tpu_torch.core import checkpoint, timet as tt
from timetuning_tpu_torch.core import train as ttrain
from timetuning_tpu_torch.core.optimizer import swav_optimizer
from test_torch_timet import _assert_leaves_close, _flat
from timetuning_tpu_torch.models.convert import timet_params_to_jax, timet_state_dict_from_jax
from timetuning_tpu_torch.models.vit import ViTConfig
from timetuning_tpu_torch.parallel import tp
from timetuning_tpu_torch.parallel.mesh import ShardSpec, make_2d_mesh
from test_torch_train_driver import voc_tree  # noqa: F401 (a fixture)
from torch_dp_worker import K, free_port, spawn, torch_model

cv2 = pytest.importorskip("cv2")

WORLD, B = 4, 4                      # ranks of the spawn; clips a global batch
CFG = dict(use_queue=True, queue_size=96)
MASK_CFG = dict(CFG, mask_features=True)
MESHES = {"2x2": (2, 2), "1x2": (1, 2)}


def one_process_checkpoint(sd, data, run_dir):
    """One process's step on the first global batch, saved: moments, teacher
    and queue all set."""
    model = torch_model(sd, VIT_DENSE)
    cfg = tt.TimeTConfig(n_prototypes=K, spatial_resolution=4, **SCHED, **CFG)
    opt, mask = swav_optimizer(model, lr=1e-3, unfreeze_layers=UNFREEZE,
                               opt_over_trainable=True, **SCHED)
    state = tt.init_state(model, cfg, opt, trainable_mask=mask)
    tt.make_train_step(model, cfg, opt, trainable_mask=mask, opt_over_trainable=True)(
        state, torch.from_numpy(data[0]), torch.Generator().manual_seed(0))
    checkpoint.save_checkpoint(state, run_dir, 1)


def one_process_steps(sd, data, draws, cfg_kw):
    """The port's one-process step on each global batch: (losses, student,
    teacher, queue)."""
    model = torch_model(sd, VIT_DENSE)
    cfg = tt.TimeTConfig(n_prototypes=K, spatial_resolution=4, **SCHED, **cfg_kw)
    opt, mask = swav_optimizer(model, lr=1e-3, unfreeze_layers=UNFREEZE,
                               opt_over_trainable=True, **SCHED)
    state = tt.init_state(model, cfg, opt, trainable_mask=mask)
    step = tt.make_train_step(model, cfg, opt, trainable_mask=mask, opt_over_trainable=True)
    it = iter(draws)
    real = tt.queue_store_indices
    tt.queue_store_indices = lambda n, k, g: torch.tensor(next(it), dtype=torch.int64)
    try:
        losses = [float(step(state, torch.from_numpy(clip), None)[1]["loss"]) for clip in data]
    finally:
        tt.queue_store_indices = real
    return losses, model.state_dict(), state.teacher, state.queue


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    params = jax_params(VIT_DENSE)
    data = clips(STEPS, B)
    rngs = list(jax.random.split(jax.random.PRNGKey(7), STEPS))
    x = np.random.default_rng(3).normal(size=(B, 32, 32, 3)).astype(np.float32)
    sd = timet_state_dict_from_jax(params)
    one = str(tmp_path_factory.mktemp("one_process"))
    one_process_checkpoint(sd, data, one)
    back = str(tmp_path_factory.mktemp("through_tp"))
    base = dict(kind="mesh_step", mesh="tp", state_dict=sd, vit=VIT_DENSE, cfg=CFG,
                unfreeze=UNFREEZE, clips=data, draws=queue_draws(rngs, B * N, 40), x=x)
    job = [dict(base, name=name, dp=dp, n=n) for name, (dp, n) in MESHES.items()]
    job.append(dict(base, name="mask", dp=2, n=2, cfg=MASK_CFG))
    job.append(dict(base, name="ckpt", dp=2, n=2, load_dir=one, save_dir=back))
    job.append(dict(kind="gather", name="gather", dp=2, n=2))
    ranks = spawn(job, str(tmp_path_factory.mktemp("tp_ranks")), WORLD, timeout=300)
    jl, _, jstate = jax_steps(VIT_DENSE, params, data, rngs, CFG)
    jv = JVisionTransformer(JViTConfig(attn_impl="xla", **VIT_DENSE))
    fwd = jv.apply({"params": params["feature_extractor"]["backbone"]}, x,
                   want_attention=True)
    mask = (jax_steps(VIT_DENSE, params, data[:1], rngs[:1], MASK_CFG)[0][0],
            one_process_steps(sd, data, base["draws"], MASK_CFG))
    return dict(ranks=ranks, jax=(jl, jstate), tokens=np.asarray(fwd["tokens"]),
                attention=np.asarray(fwd["attention"]), params=params, one=one,
                back=back, mask=mask)


def on_mesh(setup, name):
    return [r[name] for r in setup["ranks"] if r[name]]


@pytest.mark.parametrize("name", list(MESHES))
def test_tp_forward_matches_jax_single_device(setup, name):
    """The tokens, and the last block's probabilities: every head's, in
    head order, gathered over the model axis."""
    dp, n = MESHES[name]
    ranks = on_mesh(setup, name)
    assert len(ranks) == dp * n
    for r in ranks:
        b = B // dp
        d = r["coords"][0]
        np.testing.assert_allclose(r["tokens"].numpy(), setup["tokens"][d * b:(d + 1) * b],
                                   rtol=1e-5, atol=1e-5)
        assert r["attention"].shape == (b, 2, 17, 17)
        np.testing.assert_allclose(r["attention"].numpy(),
                                   setup["attention"][d * b:(d + 1) * b], rtol=1e-5, atol=1e-5)


def test_tp_mask_features_steps_match_one_process(setup):
    """``mask_features`` on the ``dp 2 x tp 2`` mesh: the masks come from
    the probabilities gathered over the model axis (detached there, as in
    one process). The first loss is JAX's single-device one (JAX's step turns
    its parameters into NaN at its first update, ROADMAP's standing
    differences, so it is held no further); the 3 steps are the port's
    one-process step's: losses, every gathered leaf, the teacher, the
    queue."""
    jl0, (losses, params, teacher, queue) = setup["mask"]
    want = _flat(timet_params_to_jax(params))
    want_t = _flat(timet_params_to_jax({**params, **teacher}))
    ranks = on_mesh(setup, "mask")
    assert len(ranks) == 4
    for r in ranks:
        np.testing.assert_allclose(r["losses"][0], jl0, rtol=1e-5)
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        _assert_leaves_close(_flat(timet_params_to_jax(r["params"])), want)
        _assert_leaves_close(_flat(timet_params_to_jax({**r["params"], **r["teacher"]})),
                             want_t)
        np.testing.assert_allclose(r["queue"].numpy(), queue.numpy(), rtol=1e-5, atol=1e-5)
    assert np.isfinite(losses).all() and losses[-1] != losses[0]


@pytest.mark.parametrize("name", list(MESHES))
def test_tp_steps_match_jax_single_device_on_the_concatenated_batch(setup, name):
    """Loss, every gathered leaf (the sharded qkv, fc1, proj, fc2 updates
    among them), the teacher and the one global queue after 3 steps."""
    jl, jstate = setup["jax"]
    for r in on_mesh(setup, name):
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
        assert_matches_jax_state(r["params"], r["teacher"], jstate, setup["params"])
        assert r["queue_fill"] == int(jstate.queue_fill) == 96
        np.testing.assert_allclose(r["queue"].numpy(), np.asarray(jstate.queue),
                                   rtol=1e-5, atol=1e-5)
    assert on_mesh(setup, name)[0]["losses"][0] != on_mesh(setup, name)[0]["losses"][-1]


def test_gather_along_order_and_gradient(setup):
    """``gather_along`` on the model axis of the ``2 x 2`` mesh: the ranks'
    slices in inner-index order (the heads' order), the same on both ranks
    of a row; the backward hands each rank the gradient of its own slice."""
    ranks = [r["gather"] for r in setup["ranks"]]
    for r in ranks:
        o, i = r["coords"]
        row = r["grid"][o]
        want = torch.cat([torch.full((2, 1, 3), float(g)) for g in row], 1)
        assert torch.equal(r["y"], want)
        assert torch.equal(r["grad"], r["w"][:, i:i + 1])


@pytest.mark.parametrize("name", list(MESHES))
def test_tp_state_layout_and_replicas(setup, name):
    """Each rank holds half of qkv (its head's q, k and v rows), fc1, proj
    and fc2 of every block, in the student, the teacher and the moments;
    the replicated state is bit-identical on every rank of the mesh, the
    sharded state across the data axis."""
    ranks = on_mesh(setup, name)
    b = "feature_extractor.backbone.blocks.3."
    for r in ranks:
        s = r["shapes"]
        assert len(s) == 4 * 6
        assert s[b + "attn.qkv.weight"] == (48, 32) and s[b + "attn.qkv.bias"] == (48,)
        assert s[b + "mlp.fc1.weight"] == (64, 32) and s[b + "mlp.fc1.bias"] == (64,)
        assert s[b + "attn.proj.weight"] == (32, 16) and s[b + "mlp.fc2.weight"] == (32, 64)
        assert r["shardings"][f"params.{b}attn.qkv.weight"] == ShardSpec(0, 3)
        assert r["shardings"][f"opt.{b}attn.proj.weight.exp_avg"] == ShardSpec(1)
        assert f"teacher.{b}mlp.fc1.weight" in r["sharded"]
        assert f"params.{b}attn.proj.bias" in r["replicated"]
    a = ranks[0]["replicated"]
    for r in ranks[1:]:
        assert r["replicated"].keys() == a.keys()
        for k in a:
            assert torch.equal(r["replicated"][k], a[k]), k
    for r in ranks:
        for t in (t for t in ranks if t["coords"][1] == r["coords"][1]):
            for k, v in r["sharded"].items():
                assert torch.equal(t["sharded"][k], v), k
    assert not any(r.get("foreign_modules") for r in setup["ranks"])


def test_checkpoint_through_tp_and_back_is_bit_identical(setup):
    """A one-process checkpoint loads into TP (each rank its slices: the
    loaded parameters are the whole ones sliced), and TP's checkpoint,
    gathered to the whole layout, is the one-process checkpoint bit for
    bit: parameters, teacher, AdamW moments by name, queue."""
    one = torch.load(os.path.join(setup["one"], "checkpoint.pt"), weights_only=True)
    back = torch.load(os.path.join(setup["back"], "checkpoint.pt"), weights_only=True)
    for key in ("model", "teacher"):
        assert one[key].keys() == back[key].keys()
        for k in one[key]:
            assert torch.equal(one[key][k], back[key][k]), (key, k)
    assert one["optimizer"]["count"] == back["optimizer"]["count"] == 1
    so, sb = one["optimizer"]["state"], back["optimizer"]["state"]
    assert so.keys() == sb.keys()
    for n in so:
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(so[n][m], sb[n][m]), (n, m)
    assert torch.equal(one["queue"], back["queue"]) and one["queue_fill"] == back["queue_fill"]
    r = next(r["ckpt"] for r in setup["ranks"] if r["ckpt"]["coords"] == (1, 1))
    k = "params.feature_extractor.backbone.blocks.2.attn.qkv.weight"
    whole = one["model"][k.split(".", 1)[1]]
    want = torch.cat([whole[i * 32 + 16:(i + 1) * 32] for i in range(3)])
    assert torch.equal(r["loaded"][k], want)


def test_tp_geometry_and_step_checks_raise_as_jax():
    with pytest.raises(ValueError, match="num_heads=2 not divisible by tp=4"):
        tp.validate_tp_geometry(ViTConfig(**VIT_DENSE), 4)
    with pytest.raises(ValueError, match="widths not divisible by tp=2"):
        tp.validate_tp_geometry(ViTConfig(**dict(VIT_DENSE, mlp_ratio=4.1)), 2)
    mesh = make_2d_mesh(1, 1, ("data", "model"))
    model = torch_model(vit_kw=VIT_DENSE)
    opt, _ = swav_optimizer(model, num_steps=10)
    with pytest.raises(ValueError, match="axis_name=None, world_size=1"):
        tp.make_tp_train_step(model, tt.TimeTConfig(world_size=2), opt, mesh)
    specs = tp.vit_param_specs(dict(model.named_parameters()))
    b = "feature_extractor.backbone.blocks.0."
    assert specs[b + "attn.qkv.weight"] == ShardSpec(0, 3)
    assert specs[b + "mlp.fc2.weight"] == ShardSpec(1)
    assert specs[b + "mlp.fc2.bias"] is None and specs[b + "norm1.weight"] is None
    assert specs["prototypes"] is None
    for kw, msg in ((dict(tensor_parallel=2), "must divide the 1 devices"),
                    (dict(tensor_parallel=0), ">= 1")):
        with pytest.raises(ValueError, match=msg):
            ttrain._check_parallel(ttrain.TrainingConfig(**kw), 1)
    with pytest.raises(ValueError, match="zero1 and tensor_parallel are mutually exclusive"):
        ttrain._check_parallel(ttrain.TrainingConfig(tensor_parallel=2, zero1=True), 2)


def test_tp_feature_fn_and_attention_probabilities_on_a_one_rank_mesh():
    """On a 1 x 1 mesh the factory is the plain forward, and the whole
    weights go in and come back out of a sharded module unchanged."""
    from timetuning_tpu_torch.models.vit import VisionTransformer

    mesh = make_2d_mesh(1, 1, ("data", "model"))
    vit = VisionTransformer(ViTConfig(**VIT_DENSE)).init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = vit(x, want_attention=True)
    fwd = tp.tp_feature_fn(VisionTransformer(ViTConfig(**VIT_DENSE)), mesh)(vit.state_dict())
    torch.testing.assert_close(fwd(x), want["tokens"], rtol=0, atol=0)
    assert want["attention"].shape == (2, 2, 17, 17)
    other = VisionTransformer(ViTConfig(**VIT_DENSE))
    tp.shard_params(mesh, other)
    tp.put_state_global(other, vit.state_dict())
    assert all(torch.equal(v, tp.gather_global_params(other)[k])
               for k, v in vit.state_dict().items())


def test_cli_train_tensor_parallel_on_two_ranks_then_one_process(tmp_path, voc_tree):
    """``cli/train --multihost true --tensor_parallel 2`` on 2 gloo ranks: an
    epoch of 2 steps, then a resumed second epoch in the same run dir (the
    meta says tensor_parallel 2, world 1, the global queue's 64 rows), rank
    0 evaluating on Pascal at each epoch's top on the gathered parameters
    and exporting the best; then one process resumes the TP checkpoint for
    a third epoch."""
    from test_torch_dp import write_davis

    root = write_davis(str(tmp_path / "davis"))
    logs = str(tmp_path / "logs")
    argv = ["--device", "cpu", "--architecture", "vit-tiny-test", "--dataset", "davis",
            "--data_root", root, "--log_dir", logs, "--batch_size", "1",
            "--num_frames", "3", "--num_workers", "0", "--num_clusters", "8",
            "--input_resolution", "32", "--n_last_frames", "2",
            "--size_mask_neighborhood", "1", "--compute_dtype", "float32",
            "--unfreeze_layers", "blocks.1", "--use_queue", "true", "--queue_size", "64",
            "--tensor_parallel", "2", "--pascal_root", voc_tree, "--eval_every", "1",
            "--eval_num_clusters", "2"]
    job = [dict(kind="cli", name="cli", ports=[free_port(), free_port()],
                argvs=[argv + ["--num_epochs", "1"],
                       argv + ["--num_epochs", "2", "--load_checkpoint", "true"]])]
    r0, r1 = spawn(job, str(tmp_path / "ranks"), 2, timeout=240)
    dirs = [[x.split("run_dir=")[1].split()[0] for x in out.splitlines()
             if x.startswith("done: run_dir=")][0] for out in r0["cli"]["printed"]]
    assert dirs[0] == dirs[1] and len(os.listdir(logs)) == 1
    assert [x for x in r1["cli"]["printed"] if "done: run_dir=" in x]
    meta = json.load(open(os.path.join(dirs[0], "checkpoint_meta.json")))
    assert meta["tensor_parallel"] == 2 and meta["world_size"] == 1
    assert meta["queue_rows_per_device"] == 64
    saved = torch.load(os.path.join(dirs[0], "checkpoint.pt"), weights_only=True)
    assert saved["step"] == 4 and saved["epoch"] == 2 and saved["queue"].shape[0] == 64
    assert saved["model"]["feature_extractor.backbone.blocks.1.attn.qkv.weight"].shape == (96, 32)
    rows = [json.loads(x) for x in open(os.path.join(dirs[0], "metrics.jsonl"))]
    assert [x["step"] for x in rows if x["tag"] == "Loss/train"] == [1, 2, 3, 4]
    scores = [x["value"] for x in rows if x["tag"] == "Scores/localization"]
    assert len(scores) == 2 and all(0.0 <= v <= 1.0 for v in scores)
    best = [f for f in os.listdir(dirs[0]) if f.endswith(".pth")]
    assert best and torch.load(os.path.join(dirs[0], best[0]), weights_only=True)[
        "feature_extractor.backbone.blocks.1.attn.qkv.weight"].shape == (96, 32)
    cfg = ttrain.TrainingConfig(
        architecture="vit-tiny-test", dataset="davis", data_root=root, log_dir=logs,
        batch_size=2, num_epochs=3, num_workers=0, num_frames=3, num_clusters=8,
        input_resolution=32, n_last_frames=2, size_mask_neighborhood=1,
        compute_dtype="float32", unfreeze_layers=("blocks.1",), use_tensorboard=False,
        use_queue=True, queue_size=64, load_checkpoint=True, device="cpu")
    r = ttrain.run_training(cfg)
    assert r["run_dir"] == dirs[0] and r["global_step"] == r["state"].step == 6
    assert np.isfinite(r["final_loss"])
