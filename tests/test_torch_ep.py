"""The port's expert parallelism (parallel/ep on a (data, expert) mesh,
parallel/mesh.make_2d_mesh and its conjugate pair, the train step on the
mesh) on the CPU: 4 gloo ranks in one spawn (tests/torch_dp_worker.py) run
a ``dp 2 x ep 2`` and a ``dp 1 x ep 2`` mesh (ranks 2 and 3 idle in the
second), held to JAX's SINGLE-DEVICE forward and step on the concatenated
batch (tests/test_ep.py:398-459 holds JAX's GSPMD step to the same, so no
GSPMD program is compiled here). Test width of tests/test_torch_moe.py: the
MoE ViT (blocks 1 and 3 MoE, 4 experts), 4 clips of 3 frames a step, the
queue on (96 rows, full at the third step), ``moe_aux_weight=0.01``, blocks
2 and 3 + head + prototypes trainable (block 3's router and experts among
them).

Tolerances: tests/test_torch_timet.py's (loss and ``moe_aux`` rtol 1e-5;
every gathered leaf, the teacher and the queue rtol 1e-5 / atol 1e-6, with
tests/test_torch_moe.py's rule for the experts' elements in Adam's eps
regime and the queue rows the teacher computes from them); the tokens at
atol 1e-5. Replicated state is compared bit for bit across all
the ranks of a mesh, sharded state across the ranks of a data axis."""

import jax
import numpy as np
import pytest
import torch

from test_torch_moe import (
    STEPS,
    UNFREEZE,
    VIT_DENSE,
    VIT_MOE,
    N,
    assert_matches_jax_state,
    assert_queue_close,
    clips,
    jax_params,
    jax_steps,
    queue_draws,
)
from timetuning_tpu.models.vit import ViTConfig as JViTConfig
from timetuning_tpu.models.vit import VisionTransformer as JVisionTransformer
from timetuning_tpu_torch.models.convert import timet_state_dict_from_jax
from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer
from timetuning_tpu_torch.parallel import ep
from timetuning_tpu_torch.parallel.mesh import ShardSpec, make_2d_mesh
from torch_dp_worker import spawn, torch_model

WORLD, B = 4, 4                      # ranks of the spawn; clips a global batch
CFG = dict(use_queue=True, queue_size=96, moe_aux_weight=0.01)
MESHES = {"2x2": (2, 2), "1x2": (1, 2)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    params = jax_params(VIT_MOE)
    data = clips(STEPS, B)
    rngs = list(jax.random.split(jax.random.PRNGKey(7), STEPS))
    x = np.random.default_rng(3).normal(size=(B, 32, 32, 3)).astype(np.float32)
    sd = timet_state_dict_from_jax(params)
    draws = queue_draws(rngs, B * N, 40)
    job = [dict(kind="mesh_step", name=name, mesh="ep", dp=dp, n=n, state_dict=sd,
                vit=VIT_MOE, cfg=CFG, unfreeze=UNFREEZE, clips=data, draws=draws, x=x)
           for name, (dp, n) in MESHES.items()]
    ranks = spawn(job, str(tmp_path_factory.mktemp("ep_ranks")), WORLD, timeout=300)
    jl, ja, jstate = jax_steps(VIT_MOE, params, data, rngs, CFG)
    jv = JVisionTransformer(JViTConfig(attn_impl="xla", **VIT_MOE))
    tokens = np.asarray(jv.apply({"params": params["feature_extractor"]["backbone"]},
                                 x)["tokens"])
    return dict(ranks=ranks, jax=(jl, ja, jstate), tokens=tokens, params=params)


def on_mesh(setup, name):
    return [r[name] for r in setup["ranks"] if r[name]]


@pytest.mark.parametrize("name", list(MESHES))
def test_ep_forward_matches_jax_single_device(setup, name):
    dp, n = MESHES[name]
    ranks = on_mesh(setup, name)
    assert len(ranks) == dp * n
    for r in ranks:
        d = r["coords"][0]
        b = B // dp
        np.testing.assert_allclose(r["tokens"].numpy(), setup["tokens"][d * b:(d + 1) * b],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(MESHES))
def test_ep_steps_match_jax_single_device_on_the_concatenated_batch(setup, name):
    """Loss, ``moe_aux``, every leaf (the routers' and the experts'
    updates), the teacher and the one global queue after 3 steps."""
    jl, ja, jstate = setup["jax"]
    for r in on_mesh(setup, name):
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
        np.testing.assert_allclose(r["aux"], ja, rtol=1e-5)
        assert_matches_jax_state(r["params"], r["teacher"], jstate, setup["params"])
        assert r["queue_fill"] == int(jstate.queue_fill) == 96
        assert_queue_close(r["queue"].numpy(), np.asarray(jstate.queue))
    r0 = on_mesh(setup, name)[0]
    assert r0["losses"][0] != r0["losses"][-1]
    router = "feature_extractor.backbone.blocks.3.moe.router.weight"
    assert not torch.equal(r0["params"][router], timet_state_dict_from_jax(
        jax_params(VIT_MOE))[router])


@pytest.mark.parametrize("name", list(MESHES))
def test_ep_state_layout_and_replicas(setup, name):
    """Each rank holds 2 of the 4 experts of both MoE blocks (student,
    teacher, moments); the replicated state (the queue included) is bit-
    identical on every rank of the mesh, the sharded state across the data
    axis."""
    dp, n = MESHES[name]
    ranks = on_mesh(setup, name)
    for r in ranks:
        shapes = r["shapes"]
        assert set(shapes) == {f"feature_extractor.backbone.blocks.{i}.moe.{leaf}"
                               for i in (1, 3) for leaf in ("w1", "b1", "w2", "b2")}
        assert shapes["feature_extractor.backbone.blocks.3.moe.w1"] == (2, 32, 128)
        assert shapes["feature_extractor.backbone.blocks.1.moe.b2"] == (2, 32)
        assert r["partition"]["params"] == r["partition"]["opt"] == "sharded"
        assert r["partition"]["queue"] == "replicated"
        assert all(spec == ShardSpec(0) for spec in r["shardings"].values())
        assert "opt.feature_extractor.backbone.blocks.3.moe.w1.exp_avg" in r["sharded"]
        assert "queue" in r["replicated"]
    a = ranks[0]["replicated"]
    for r in ranks[1:]:
        assert r["replicated"].keys() == a.keys()
        for k in a:
            assert torch.equal(r["replicated"][k], a[k]), k
    for r in ranks:
        twin = [t for t in ranks if t["coords"][1] == r["coords"][1]]
        for t in twin:
            for k, v in r["sharded"].items():
                assert torch.equal(t["sharded"][k], v), k
    e0, e1 = (next(r for r in ranks if r["coords"] == (0, i)) for i in (0, 1))
    key = "params.feature_extractor.backbone.blocks.3.moe.w1"
    assert not torch.equal(e0["sharded"][key], e1["sharded"][key])
    assert not any(r.get("foreign_modules") for r in setup["ranks"])


def test_ep_geometry_and_specs_raise_as_jax():
    """``validate_ep_geometry``, the feature and train-step factories on a
    dense backbone, the expert-stacked parameter test with its shape guard,
    and ``make_2d_mesh`` asking for more ranks than there are."""
    with pytest.raises(ValueError, match="not divisible"):
        ep.validate_ep_geometry(6, 4)
    mesh = make_2d_mesh(1, 1, ("data", "expert"))
    assert mesh.coords == (0, 0) and mesh.outer is None and mesh.inner is None
    with pytest.raises(ValueError, match=r"data\*expert=4 exceeds 1 devices"):
        ep.make_dp_ep_mesh(2, 2)
    dense = VisionTransformer(ViTConfig(**VIT_DENSE))
    with pytest.raises(ValueError, match="MoE"):
        ep.make_ep_feature_fn(dense, mesh)
    from timetuning_tpu_torch.core.optimizer import swav_optimizer
    from timetuning_tpu_torch.core.timet import TimeTConfig

    model = torch_model(vit_kw=VIT_DENSE)
    opt, _ = swav_optimizer(model, num_steps=10)
    with pytest.raises(ValueError, match="needs a MoE ViT backbone"):
        ep.make_ep_train_step(model, TimeTConfig(), opt, mesh)
    moe = VisionTransformer(ViTConfig(**dict(VIT_MOE, n_experts=6)))
    with pytest.raises(ValueError, match="not divisible"):
        ep.shard_experts(ep.Mesh2D(("data", "expert"), {"data": 1, "expert": 4},
                                   None, None, (0, 0), ((0, 1, 2, 3),)), moe)
    named = dict(VisionTransformer(ViTConfig(**VIT_MOE)).named_parameters())
    named["other.w1"] = torch.zeros(7, 3)
    specs = ep.ep_param_specs(named, n_experts=4)
    assert specs["blocks.1.moe.w1"] == ShardSpec(0)
    assert specs["blocks.1.moe.router.weight"] is None
    assert specs["blocks.0.mlp.fc1.weight"] is None and specs["other.w1"] is None
    assert ep.ep_param_specs(named)["other.w1"] == ShardSpec(0)
    with pytest.raises(ValueError, match="axis_name=None"):
        ep.make_ep_train_step(torch_model(vit_kw=VIT_MOE), TimeTConfig(axis_name="data"),
                              opt, mesh)


def test_ep_moe_layer_and_feature_fn_on_a_one_rank_mesh():
    """On a 1 x 1 mesh the factories are the plain layer and forward."""
    mesh = make_2d_mesh(1, 1, ("data", "expert"))
    layer = ep.MoEMlp(16, 4, 32, 2.0, group_size=-1).eval()
    torch.nn.init.normal_(layer.router.weight, generator=torch.Generator().manual_seed(0))
    layer.init_experts(torch.Generator().manual_seed(1))
    x = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(2))
    want = layer(x)
    got = ep.make_ep_moe_fn(ep.MoEMlp(16, 4, 32, 2.0, group_size=-1), mesh)(
        layer.state_dict())(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    vit = VisionTransformer(ViTConfig(**VIT_MOE)).init_weights(torch.Generator().manual_seed(3))
    xi = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = vit(xi)["tokens"]
    fwd = ep.make_ep_feature_fn(VisionTransformer(ViTConfig(**VIT_MOE)), mesh)(vit.state_dict())
    torch.testing.assert_close(fwd(xi), want, rtol=0, atol=0)
