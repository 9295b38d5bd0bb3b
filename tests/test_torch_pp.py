"""The port's pipeline parallelism (parallel/pp on a (data, pipe) mesh: the
stage split, the GPipe schedule, the hop between stages) on the CPU. 4 gloo
ranks in one spawn (tests/torch_dp_worker.py) run the forward at (dp, pp,
n_micro) = (1, 4, 4), (2, 2, 2), (1, 2, 4) and (1, 2, auto) (ranks 2 and 3
idle at pp 2 with dp 1), held to JAX's ``make_pp_feature_fn`` at the same
geometries on the conftest's virtual 8-device mesh, and the parameter
gradients of ``sum(tokens ** 2)`` at JAX's two geometries
(tests/test_pp.py:127-131), summed over the mesh, held to JAX's
single-device gradients. Test width of tests/test_pp.py: patch 8, D 32, 2
heads, 32 px (17 tokens), depth 4 and batch 8 for the forward, depth 2 for
the gradients; f32. Beside them, JAX's auto rule, geometry checks and MoE
refusal against the port's.

Tolerances: the forward at JAX's rtol 2e-4 / atol 2e-5
(tests/test_pp.py:58); the gradients at rtol 1e-3 / atol 2e-4 (:141)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetuning_tpu.models.vit import ViTConfig as JViTConfig
from timetuning_tpu.models.vit import VisionTransformer as JVisionTransformer
from timetuning_tpu.parallel import pp as jpp
from timetuning_tpu_torch.models.convert import vit_state_dict_from_jax
from timetuning_tpu_torch.models.export_torch import vit_params_to_torch
from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer
from timetuning_tpu_torch.parallel import pp
from torch_dp_worker import spawn

WORLD = 4
VIT = dict(patch_size=8, embed_dim=32, num_heads=2, img_size=32)
FORWARD = {"1x4 nm4": (1, 4, 4), "2x2 nm2": (2, 2, 2), "1x2 nm4": (1, 2, 4),
           "1x2 auto": (1, 2, None)}
GRAD = {"grad 1x2": (1, 2, 2, 2), "grad 2x2": (2, 2, 4, 2)}     # dp, pp, batch, n_micro


def jax_model(depth: int, batch: int):
    model = JVisionTransformer(JViTConfig(attn_impl="xla", depth=depth, **VIT))
    x = np.random.default_rng(0).normal(size=(batch, 32, 32, 3)).astype(np.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]
    return model, params, x


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    fwd = jax_model(4, 8)
    job = [dict(kind="seq_pipe", mesh="pp", name=name, dp=dp, n=n, n_micro=nm,
                vit=dict(VIT, depth=4, dtype=torch.float32),
                state_dict=vit_state_dict_from_jax(fwd[1]), x=fwd[2])
           for name, (dp, n, nm) in FORWARD.items()]
    grads = {}
    for name, (dp, n, batch, nm) in GRAD.items():
        grads[name] = jax_model(2, batch)
        job.append(dict(kind="seq_pipe", mesh="pp", name=name, dp=dp, n=n, n_micro=nm,
                        vit=dict(VIT, depth=2, dtype=torch.float32),
                        state_dict=vit_state_dict_from_jax(grads[name][1]),
                        x=grads[name][2], grad=True))
    ranks = spawn(job, str(tmp_path_factory.mktemp("pp_ranks")), WORLD, timeout=300)
    return dict(ranks=ranks, fwd=fwd, grads=grads)


def on_mesh(setup, name):
    return [r[name] for r in setup["ranks"] if r[name]]


@pytest.mark.parametrize("name", list(FORWARD))
def test_pp_forward_matches_jax_pp(setup, name):
    dp, n, nm = FORWARD[name]
    model, params, x = setup["fwd"]
    want = np.asarray(jpp.make_pp_feature_fn(model, jpp.make_dp_pp_mesh(dp, n),
                                             n_micro=nm)(params, x))
    ranks = on_mesh(setup, name)
    assert len(ranks) == dp * n
    b = x.shape[0] // dp
    for r in ranks:
        d = r["coords"][0]
        np.testing.assert_allclose(r["tokens"].numpy(), want[d * b:(d + 1) * b],
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", list(FORWARD))
def test_each_rank_holds_only_its_stage(setup, name):
    """A rank's state dict holds its stage's ``depth / pp`` blocks under their
    own names, the embedding and the final norm, and no other block."""
    _, n, _ = FORWARD[name]
    per = 4 // n
    for r in on_mesh(setup, name):
        stage = r["coords"][1]
        blocks = {int(k.split(".")[1]) for k in r["held"] if k.startswith("blocks.")}
        assert blocks == set(range(stage * per, (stage + 1) * per))
        assert {"cls_token", "pos_embed", "norm.weight", "patch_embed.proj.weight"} <= set(r["held"])


@pytest.mark.parametrize("name", list(GRAD))
def test_pp_gradients_summed_over_the_mesh_match_jax(setup, name):
    """The GPipe schedule's backward (the reverse hop, bubble ticks adding
    exactly zero) summed over the mesh: JAX's single-device gradient."""
    model, params, x = setup["grads"][name]
    g = jax.grad(lambda p: jnp.sum(model.apply({"params": p}, x)["tokens"] ** 2))(params)
    want = {k: np.asarray(v) for k, v in vit_params_to_torch(g).items()}
    ranks = on_mesh(setup, name)
    got = {k: sum(r["grads"][k] for r in ranks if k in r["grads"]).numpy() for k in want}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-3, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("b_local,n_pipe", [(b, p) for b in (1, 2, 3, 4, 6, 8, 12)
                                            for p in (1, 2, 3, 4)])
def test_auto_n_micro_is_jaxs_rule(b_local, n_pipe):
    assert pp._auto_n_micro(b_local, n_pipe) == jpp._auto_n_micro(b_local, n_pipe)


@pytest.mark.parametrize("geometry", [
    dict(depth=3, pp=2, batch=4, dp=1, n_micro=1),
    dict(depth=4, pp=2, batch=5, dp=2, n_micro=1),
    dict(depth=4, pp=2, batch=4, dp=2, n_micro=4),
    dict(depth=4, pp=2, batch=8, dp=2, n_micro=2),
])
def test_geometry_checks_raise_as_jax(geometry):
    depth = geometry.pop("depth")
    jcfg, tcfg = JViTConfig(depth=depth, **VIT), ViTConfig(depth=depth, **VIT)
    try:
        jpp.validate_pp_geometry(jcfg, **geometry)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            pp.validate_pp_geometry(tcfg, **geometry)
    else:
        pp.validate_pp_geometry(tcfg, **geometry)


def test_stage_split_and_mesh_errors_are_jaxs():
    model, params, _ = jax_model(3, 2)
    with pytest.raises(ValueError) as jerr:
        jpp.stack_stage_params(params, 2)
    with pytest.raises(ValueError, match=str(jerr.value)):
        pp.stage_blocks(3, 2, 0)
    assert list(pp.stage_blocks(12, 2, 1)) == list(range(6, 12))
    with pytest.raises(ValueError, match="exceeds"):
        jpp.make_dp_pp_mesh(4, 4)
    with pytest.raises(ValueError, match="exceeds"):
        pp.make_dp_pp_mesh(4, 4)


def test_moe_vit_is_refused_as_jax_refuses_it():
    jm = JVisionTransformer(JViTConfig(depth=2, moe_every_k=2, n_experts=2, **VIT))
    with pytest.raises(ValueError) as jerr:
        jpp.pp_forward_fn(jm, jpp.make_dp_pp_mesh(1, 2), None)
    tm = VisionTransformer(ViTConfig(depth=2, moe_every_k=2, n_experts=2, **VIT))
    with pytest.raises(ValueError) as terr:
        pp.pp_forward_fn(tm, pp.make_dp_pp_mesh(1, 1))
    assert str(terr.value) == str(jerr.value)
