"""The port's last model files against the JAX package's on weights carried
across by ``models/convert.flax_state_dict`` and the same numpy inputs: the
FCN decode head (eval and train mode), the DINO head with its
weight-normalised layer, the multi-crop wrapper, the generic transformer
(attention with a mask, encoder, causal decoder) and the Gumbel helpers on
JAX's own uniform draws (the same key split as the JAX helpers). Also
``ViTConfig.remat``: gradients equal to those without it, on the plain
blocks and through the bf16 block kernels' Functions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetuning_tpu.models import dino_head as jdh
from timetuning_tpu.models import fcn as jfcn
from timetuning_tpu.models import generic_transformer as jgt
from timetuning_tpu.models.vit import ViTConfig as JViTConfig
from timetuning_tpu.models.vit import VisionTransformer as JVisionTransformer
from timetuning_tpu_torch.models import dino_head as tdh
from timetuning_tpu_torch.models import fcn as tfcn
from timetuning_tpu_torch.models import generic_transformer as tgt
from timetuning_tpu_torch.models.convert import flax_state_dict, vit_state_dict_from_jax
from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _load(module, variables, **kw):
    """Carry Flax variables into ``module``; only BatchNorm's batch counter
    may be missing."""
    res = module.load_state_dict(flax_state_dict(variables, **kw), strict=False)
    assert not res.unexpected_keys, res.unexpected_keys
    assert all(k.endswith("num_batches_tracked") for k in res.missing_keys), res.missing_keys
    return module


@pytest.mark.parametrize("concat", [True, False])
def test_fcn_head_matches_jax(concat):
    x = _x(2, 6, 7, 16)
    jm = jfcn.FCNHead(num_classes=5, channels=8, concat_input=concat)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # non-trivial running statistics
    variables = {"params": variables["params"], "batch_stats": jax.tree.map(
        lambda a: a + 0.3 * jnp.asarray(_x(*a.shape, seed=a.size)) ** 2,
        variables["batch_stats"])}
    tm = _load(tfcn.FCNHead(16, 5, channels=8, concat_input=concat), variables).eval()
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # train mode: batch statistics, and the running ones updated alike
    jm0 = jfcn.FCNHead(num_classes=5, channels=8, concat_input=concat, dropout=0.0)
    want, upd = jm0.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm = _load(tfcn.FCNHead(16, 5, channels=8, concat_input=concat, dropout=0.0),
               variables).train()
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    sd = tm.state_dict()
    for k, v in flax_state_dict(upd).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), err_msg=k, **TOL)


@pytest.mark.parametrize("use_bn,norm_last", [(False, True), (True, False)])
def test_dino_head_matches_jax(use_bn, norm_last):
    x = _x(5, 24)
    jm = jdh.DINOHead(out_dim=40, hidden_dim=32, bottleneck_dim=16, use_bn=use_bn,
                      norm_last_layer=norm_last)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tm = _load(tdh.DINOHead(24, out_dim=40, hidden_dim=32, bottleneck_dim=16,
                            use_bn=use_bn, norm_last_layer=norm_last), variables)
    want = jm.apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), **TOL)
    # the fixed g of norm_last_layer gets no gradient, as JAX's stop_gradient
    assert tm.last_layer.g.requires_grad is (not norm_last)
    jgrad = jax.grad(lambda p: jm.apply({**variables, "params": p},
                                        jnp.asarray(x)).sum())(variables["params"])
    tm(torch.from_numpy(x)).sum().backward()
    np.testing.assert_allclose(tm.last_layer.v.grad.numpy(),
                               np.asarray(jgrad["last_layer"]["v"]), **TOL)
    if not norm_last:
        np.testing.assert_allclose(tm.last_layer.g.grad.numpy(),
                                   np.asarray(jgrad["last_layer"]["g"]), **TOL)


def test_multi_crop_wrapper_matches_jax():
    cfg = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, img_size=32)
    crops = [_x(2, 32, 32, 3, seed=1), _x(2, 32, 32, 3, seed=2), _x(3, 16, 16, 3, seed=3),
             _x(1, 32, 32, 3, seed=4)]
    jm = jdh.MultiCropWrapper(JVisionTransformer(JViTConfig(attn_impl="xla", **cfg)),
                              jdh.DINOHead(out_dim=12, hidden_dim=16, bottleneck_dim=8))
    variables = jm.init(jax.random.PRNGKey(2), [jnp.asarray(c) for c in crops])
    params = variables["params"]
    backbone = VisionTransformer(ViTConfig(**cfg))
    backbone.load_state_dict(vit_state_dict_from_jax(params["backbone"]))
    head = _load(tdh.DINOHead(32, out_dim=12, hidden_dim=16, bottleneck_dim=8),
                 {"params": params["head"]})
    tm = tdh.MultiCropWrapper(backbone, head)
    want = jm.apply(variables, [jnp.asarray(c) for c in crops])
    with torch.no_grad():
        got = tm([torch.from_numpy(c) for c in crops])
    assert got.shape == (8, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_encoder_and_decoder_match_jax():
    x, mem = _x(2, 7, 16, seed=5), _x(2, 5, 16, seed=6)
    mask = np.random.default_rng(7).uniform(size=(2, 1, 7, 7)) > 0.3
    mask[..., 0] = True
    jatt = jgt.MultiHeadAttention(num_heads=4)
    v = jatt.init(jax.random.PRNGKey(3), *(jnp.asarray(x),) * 3, jnp.asarray(mask))
    tatt = _load(tgt.MultiHeadAttention(16, 4), v)
    (wo, wp) = jatt.apply(v, *(jnp.asarray(x),) * 3, jnp.asarray(mask))
    with torch.no_grad():
        go, gp = tatt(*(torch.from_numpy(x),) * 3, torch.from_numpy(mask))
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), **TOL)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), **TOL)

    jenc = jgt.TransformerEncoder(depth=2, num_heads=4, mlp_dim=24)
    v = jenc.init(jax.random.PRNGKey(4), jnp.asarray(x))
    tenc = _load(tgt.TransformerEncoder(16, depth=2, num_heads=4, mlp_dim=24), v)
    with torch.no_grad():
        got = tenc(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jenc.apply(v, jnp.asarray(x))), **TOL)

    jdec = jgt.TransformerDecoder(depth=2, num_heads=4, mlp_dim=24)
    v = jdec.init(jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(mem))
    tdec = _load(tgt.TransformerDecoder(16, depth=2, num_heads=4, mlp_dim=24), v)
    with torch.no_grad():
        got = tdec(torch.from_numpy(x), torch.from_numpy(mem))
    want = jdec.apply(v, jnp.asarray(x), jnp.asarray(mem))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gumbel_helpers_match_jax_on_its_draws():
    """The uniforms JAX draws from a key (``jax.random.uniform(key, shape)``,
    what ``sample_gumbel`` does), handed to the port's helpers."""
    logits = _x(6, 9, seed=8)
    key = jax.random.PRNGKey(9)
    u = np.asarray(jax.random.uniform(key, logits.shape))
    np.testing.assert_allclose(tgt.sample_gumbel(logits.shape, u=u).numpy(),
                               np.asarray(jgt.sample_gumbel(key, logits.shape)), **TOL)
    tl = torch.from_numpy(logits)
    for hard in (False, True):
        want = jgt.gumbel_softmax(key, jnp.asarray(logits), temperature=0.7, hard=hard)
        got = tgt.gumbel_softmax(tl, temperature=0.7, hard=hard, u=u)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(tgt.gumbel_max(tl, u=u).numpy(),
                                  np.asarray(jgt.gumbel_max(key, jnp.asarray(logits))))
    # straight through: the hard sample's gradient is the soft sample's
    leaf = tl.clone().requires_grad_(True)
    w = torch.from_numpy(_x(6, 9, seed=10))
    (tgt.gumbel_softmax(leaf, 0.7, hard=True, u=u) * w).sum().backward()
    soft = tl.clone().requires_grad_(True)
    (tgt.gumbel_softmax(soft, 0.7, hard=False, u=u) * w).sum().backward()
    torch.testing.assert_close(leaf.grad, soft.grad)
    g = torch.Generator().manual_seed(0)
    draws = tgt.gumbel_max(tl[:1].expand(4000, 9), generator=g)
    freq = torch.bincount(draws, minlength=9).float() / 4000
    torch.testing.assert_close(freq, torch.softmax(tl[0], -1), atol=0.03, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_gives_the_gradients_of_no_remat(dtype):
    """``ViTConfig.remat`` recomputes each block in the backward
    (torch.utils.checkpoint); the loss and every gradient equal those without
    it. In bf16 the ``auto`` blocks are the kernel wrappers, whose Functions
    run again inside the recomputation."""
    cfg = dict(patch_size=8, embed_dim=64, depth=3, num_heads=2, img_size=32,
               dtype=dtype)
    x = torch.from_numpy(_x(2, 32, 32, 3, seed=11))
    results = []
    for remat in (False, True):
        m = VisionTransformer(ViTConfig(remat=remat, **cfg))
        m.init_weights(torch.Generator().manual_seed(0))
        loss = m(x)["tokens"].float().square().mean()
        loss.backward()
        results.append((loss.detach(), {n: p.grad.clone() for n, p in m.named_parameters()}))
    (l0, g0), (l1, g1) = results
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    assert g0.keys() == g1.keys()
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=0, msg=n)
