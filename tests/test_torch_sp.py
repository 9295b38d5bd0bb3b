"""The port's sequence parallelism (parallel/sp on a (data, seq) mesh, and
parallel/mesh.all_gather_along) on the CPU. 4 gloo ranks in one spawn
(tests/torch_dp_worker.py) run the forward at (dp, sp) = (1, 2), (2, 2) and
(1, 4) (ranks 2 and 3 idle at (1, 2)), held to JAX's ``make_sp_feature_fn``
on the conftest's virtual 8-device mesh; the parameter gradients of
``sum(tokens ** 2)`` at (1, 4) and (2, 2), summed over the mesh, held to
JAX's single-device gradients; the K/V all-gather's backward; and a bf16
``auto`` ViT's sp forward exported with ``torch.export``, whose custom ops
show the kernel route. Test width of tests/test_sp.py: patch 8, D 32, depth
3, 2 heads, 32 px (17 tokens: padded to 18 at sp 2 and to 20 at sp 4),
batch 4, f32.

Tolerances: the forward at atol 1e-5 (f32, the same composition); the
gradients at JAX's own rtol 1e-3 / atol 2e-4 (tests/test_sp.py:110)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetuning_tpu.models.vit import ViTConfig as JViTConfig
from timetuning_tpu.models.vit import VisionTransformer as JVisionTransformer
from timetuning_tpu.parallel.sp import make_dp_sp_mesh as jmesh
from timetuning_tpu.parallel.sp import make_sp_feature_fn as jmake_sp
from timetuning_tpu_torch.models.convert import vit_state_dict_from_jax
from timetuning_tpu_torch.models.export_torch import vit_params_to_torch
from timetuning_tpu_torch.parallel import sp
from torch_dp_worker import spawn

WORLD = 4
VIT = dict(patch_size=8, embed_dim=32, depth=3, num_heads=2, img_size=32)
FORWARD = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
GRAD = {"grad 1x4": (1, 4), "grad 2x2": (2, 2)}
# a bf16 ViT whose sp slabs exceed 1,024 rows: patch 4 at 184 px, 2,117
# tokens, 1,059 rows a slab at sp 2 (K9), 530 at sp 4 (K2)
LONG = dict(patch_size=4, embed_dim=64, depth=1, num_heads=2, img_size=184)
LONG_OPS = {2: {"ln_dense_rows", "flash_attention", "dense_residual_rows", "mlp_rows"},
            4: {"ln_dense_rows", "flash_attention", "dense_residual_rows", "mlp_block_branch"}}


def jax_model():
    model = JVisionTransformer(JViTConfig(attn_impl="xla", **VIT))
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(np.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]
    return model, params, x


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    model, params, x = jax_model()
    sd = vit_state_dict_from_jax(params)
    vit = dict(VIT, dtype=torch.float32)
    job = [dict(kind="seq_pipe", mesh="sp", name=name, dp=dp, n=n, vit=vit,
                state_dict=sd, x=x) for name, (dp, n) in FORWARD.items()]
    job += [dict(kind="seq_pipe", mesh="sp", name=name, dp=dp, n=n, vit=vit,
                 state_dict=sd, x=x, grad=True) for name, (dp, n) in GRAD.items()]
    job.append(dict(kind="all_gather", name="all_gather", dp=2, n=2))
    job += [dict(kind="sp_export", name=f"export sp{n}", n=n, vit=LONG) for n in LONG_OPS]
    ranks = spawn(job, str(tmp_path_factory.mktemp("sp_ranks")), WORLD, timeout=300)
    return dict(ranks=ranks, model=model, params=params, x=x)


def on_mesh(setup, name):
    return [r[name] for r in setup["ranks"] if r[name]]


@pytest.mark.parametrize("name", list(FORWARD))
def test_sp_forward_matches_jax_sp(setup, name):
    dp, n = FORWARD[name]
    want = np.asarray(jmake_sp(setup["model"], jmesh(dp, n))(setup["params"], setup["x"]))
    ranks = on_mesh(setup, name)
    assert len(ranks) == dp * n
    b = want.shape[0] // dp
    for r in ranks:
        d = r["coords"][0]
        assert r["tokens"].shape == (b, 17, 32)
        np.testing.assert_allclose(r["tokens"].numpy(), want[d * b:(d + 1) * b],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(GRAD))
def test_sp_gradients_summed_over_the_mesh_match_jax(setup, name):
    model, params, x = setup["model"], setup["params"], setup["x"]
    g = jax.grad(lambda p: jnp.sum(model.apply({"params": p}, x)["tokens"] ** 2))(params)
    want = {k: np.asarray(v) for k, v in vit_params_to_torch(g).items()}
    ranks = on_mesh(setup, name)
    got = {k: sum(r["grads"][k] for r in ranks if k in r["grads"]).numpy() for k in want}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-3, atol=2e-4, err_msg=k)


def test_all_gather_along_backward_sums_the_ranks_gradients(setup):
    """Forward: the ranks' blocks side by side in the seq group's order.
    Backward: each rank's gradient is its slice of the SUM of the ranks'
    cotangents (JAX's reduce-scatter transpose), where ``gather_along``
    keeps only its own."""
    ranks = on_mesh(setup, "all_gather")
    grid = ranks[0]["grid"]
    for r in ranks:
        o, i = r["coords"]
        row = grid[o]
        np.testing.assert_array_equal(
            r["y"].numpy(), np.concatenate([np.full((2, 1, 3), float(g)) for g in row], 1))
        peers = [q for q in ranks if q["coords"][0] == o]
        want = sum(q["w"][:, i:i + 1] for q in peers)
        torch.testing.assert_close(r["grad"], want, rtol=0, atol=0)
        assert not torch.equal(r["grad"], r["w"][:, i:i + 1])


@pytest.mark.parametrize("n", list(LONG_OPS))
def test_bf16_sp_forward_takes_the_row_and_flash_kernels(setup, n):
    """A bf16 ``auto`` ViT over 1,024 tokens on a 1 x ``n`` seq mesh: the
    exported sp forward calls K7, K5/6 (local queries against the gathered
    keys, ``kv_len`` 2,117), K8 and, by the slab's length, K9 or K2 as
    custom ops, the K/V all-gather as a functional all-reduce; the program
    equals the live sp forward and the one-process forward's plain
    versions within bf16 rounding."""
    ranks = on_mesh(setup, f"export sp{n}")
    assert len(ranks) == n
    for r in ranks:
        assert r["ops"] == LONG_OPS[n]
        assert r["collectives"] == LONG["depth"] + 1
        torch.testing.assert_close(r["program"], r["live"], rtol=0, atol=0)
        cos = torch.nn.functional.cosine_similarity(r["live"].float(), r["one"].float(), dim=-1)
        assert float(cos.min()) >= 0.999


def test_sp_mesh_and_moe_refusal():
    with pytest.raises(ValueError, match="exceeds"):
        sp.make_dp_sp_mesh(4, 4)
    from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer

    moe = VisionTransformer(ViTConfig(**VIT, moe_every_k=2, n_experts=2))
    with pytest.raises(ValueError, match="MoE"):
        sp.sp_forward_fn(moe, sp.make_dp_sp_mesh(1, 1))
