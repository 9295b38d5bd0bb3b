"""The port's projection head, feature extractors, attention-mask pipeline
and morphology (timetuning_tpu_torch/models/{heads,extractor}.py,
ops/morphology.py) against the JAX package's on the same numpy-seeded
inputs, f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetuning_tpu.models import extractor as jex
from timetuning_tpu.models.heads import ProjectionHead as JProjectionHead
from timetuning_tpu.models.vit import ViTConfig as JViTConfig
from timetuning_tpu.models.vit import VisionTransformer as JVisionTransformer
from timetuning_tpu.ops import morphology as jmorph
from timetuning_tpu_torch.models import extractor as tex
from timetuning_tpu_torch.models.convert import (
    timet_state_dict_from_jax,
    vit_state_dict_from_jax,
)
from timetuning_tpu_torch.models.heads import ProjectionHead
from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer
from timetuning_tpu_torch.ops import morphology as tmorph

torch.set_num_threads(2)

VIT = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, img_size=32)


def _head_state_dict(params, prefix=""):
    sd = timet_state_dict_from_jax(
        {"feature_extractor": {"backbone": _BACKBONE_STUB, "head": params}})
    return {k.replace("feature_extractor.head.", prefix): v for k, v in sd.items()
            if k.startswith("feature_extractor.head.")}


def _vit_params(seed):
    x = jnp.zeros((1, 32, 32, 3))
    return JVisionTransformer(JViTConfig(attn_impl="xla", **VIT)).init(
        jax.random.PRNGKey(seed), x)["params"]


_BACKBONE_STUB = _vit_params(0)


@pytest.mark.parametrize("dims", [(48, 24), (64, 64, 32, 16)])
def test_projection_head_matches_jax(dims):
    """Dense -> exact GELU -> ... -> linear, in f32 on a bf16 input too."""
    x = np.random.default_rng(len(dims)).standard_normal((2, 5, 32)).astype(np.float32)
    jhead = JProjectionHead(dims)
    params = jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    # biases are zero-initialised: give them values
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * jnp.cos(jnp.arange(v.size, dtype=jnp.float32)).reshape(v.shape),
        params)
    thead = ProjectionHead(32, dims)
    thead.load_state_dict(_head_state_dict(params))
    want = np.asarray(jhead.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = thead(torch.from_numpy(x)).numpy()
        got_bf16 = thead(torch.from_numpy(x).bfloat16())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got_bf16.dtype == torch.float32
    want_bf16 = np.asarray(jhead.apply({"params": params},
                                       jnp.asarray(x).astype(jnp.bfloat16)))
    np.testing.assert_allclose(got_bf16.numpy(), want_bf16, rtol=1e-5, atol=1e-6)


def test_projection_head_init_is_seeded_lecun_normal():
    a = ProjectionHead(384, (256, 64)).init_weights(torch.Generator().manual_seed(1))
    b = ProjectionHead(384, (256, 64)).init_weights(torch.Generator().manual_seed(1))
    assert torch.equal(a.lin0.weight, b.lin0.weight)
    assert float(a.lin0.bias.abs().max()) == 0
    np.testing.assert_allclose(float(a.lin0.weight.var()), 1 / 384, rtol=0.05)


@pytest.mark.parametrize("use_head,want_attention", [(True, False), (False, True)])
def test_feature_extractor_matches_jax(use_head, want_attention):
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jfe = jex.FeatureExtractor(JVisionTransformer(JViTConfig(attn_impl="xla", **VIT)),
                               head_dims=(48, 24))
    params = jfe.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    tfe = tex.FeatureExtractor(VisionTransformer(ViTConfig(**VIT)), 32, (48, 24))
    sd = timet_state_dict_from_jax({"feature_extractor": params})
    tfe.load_state_dict({k.removeprefix("feature_extractor."): v for k, v in sd.items()})
    jf, ja = jfe.apply({"params": params}, jnp.asarray(x), use_head=use_head,
                       want_attention=want_attention)
    with torch.no_grad():
        tf, ta = tfe(torch.from_numpy(x), use_head=use_head,
                     want_attention=want_attention)
    assert tf.shape == (2, 16, 24 if use_head else 32)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-5)
    assert (ta is None) == (ja is None)
    if ta is not None:
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)


def test_feature_extractor_v2_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jfe = jex.FeatureExtractorV2(
        JVisionTransformer(JViTConfig(attn_impl="xla", **VIT)),
        segmentation_head_dims=(48, 24), propagation_head_dims=(40,))
    params = jfe.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    tfe = tex.FeatureExtractorV2(VisionTransformer(ViTConfig(**VIT)), 32, (48, 24), (40,))
    sd = {f"backbone.{k}": v for k, v in vit_state_dict_from_jax(params["backbone"]).items()}
    for head in ("segmentation_head", "propagation_head"):
        sd.update(_head_state_dict(params[head], prefix=f"{head}."))
    tfe.load_state_dict(sd)
    (js, jp), _ = jfe.apply({"params": params}, jnp.asarray(x))
    (_, jp_raw), _ = jfe.apply({"params": params}, jnp.asarray(x),
                               use_propagation_head=False)
    with torch.no_grad():
        (ts, tp), _ = tfe(torch.from_numpy(x))
        (_, tp_raw), _ = tfe(torch.from_numpy(x), use_propagation_head=False)
    for got, want in ((ts, js), (tp, jp), (tp_raw, jp_raw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _attentions(B, heads, res, seed, ties=False):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, (B, heads, 1 + res * res, 1 + res * res))
    if ties:
        a = np.round(a * 4) / 4           # five distinct values: many exact ties
    a = a / a.sum(-1, keepdims=True)
    return a.astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("res", [4, 14])
def test_process_attentions_matches_jax(res, ties):
    """Binary masks, bit for bit, also when blurred values tie (both sorts
    are stable)."""
    att = _attentions(3, 2, res, seed=res, ties=ties)
    want = np.asarray(jex.process_attentions(jnp.asarray(att), res))
    got = tex.process_attentions(torch.from_numpy(att), res).numpy()
    assert got.shape == want.shape == (3, 1, res, res)
    assert 0 < got.mean() < 1
    np.testing.assert_array_equal(got, want)


def test_process_attentions_with_constant_attention_matches_jax():
    """Every blurred value equal: the kept set is decided by the sort's tie
    order alone."""
    att = np.full((1, 2, 17, 17), 1 / 17, np.float32)
    want = np.asarray(jex.process_attentions(jnp.asarray(att), 4))
    got = tex.process_attentions(torch.from_numpy(att), 4).numpy()
    np.testing.assert_array_equal(got, want)


def test_apply_attention_mask_matches_jax():
    B, F, res, D = 2, 2, 4, 6
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((B, F, res * res, D)).astype(np.float32)
    att = _attentions(B * F, 2, res, seed=6)
    jm, jmask = jex.apply_attention_mask(jnp.asarray(feats), jnp.asarray(att), res)
    feats_t = torch.from_numpy(feats).requires_grad_(True)
    tm, tmask = tex.apply_attention_mask(feats_t, torch.from_numpy(att), res)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tm.detach().numpy(), np.asarray(jm))
    assert tm.requires_grad and not tmask.requires_grad


@pytest.mark.parametrize("shape", [(3, 9, 9), (2, 2, 14, 14)])
def test_gaussian_blur_matches_jax(shape):
    img = np.random.default_rng(7).uniform(size=shape).astype(np.float32)
    want = np.asarray(jmorph.gaussian_blur(jnp.asarray(img), ksize=7, sigma=0.6))
    got = tmorph.gaussian_blur(torch.from_numpy(img), ksize=7, sigma=0.6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tmorph.gaussian_kernel1d(7, 0.6),
                                  jmorph.gaussian_kernel1d(7, 0.6))


@pytest.mark.parametrize("seed,density", [(0, 0.2), (1, 0.45), (2, 0.8)])
def test_remove_small_components_matches_jax(seed, density):
    masks = (np.random.default_rng(seed).uniform(size=(4, 12, 12)) < density)
    masks = masks.astype(np.float32)
    want = np.stack([np.asarray(jmorph.remove_small_components(jnp.asarray(m), 3))
                     for m in masks])
    got = tmorph.remove_small_components(torch.from_numpy(masks), 3).numpy()
    np.testing.assert_array_equal(got, want)
    labels = tmorph.connected_components(torch.from_numpy(masks)).numpy()
    want_labels = np.stack([np.asarray(jmorph.connected_components(jnp.asarray(m)))
                            for m in masks])
    np.testing.assert_array_equal(labels, want_labels)


def test_remove_small_components_on_a_serpentine():
    """A one-pixel-wide snake whose flood needs far more than H + W sweeps."""
    m = np.zeros((9, 9), np.float32)
    for r in range(0, 9, 2):
        m[r, :] = 1
        if r + 1 < 9:
            m[r + 1, 8 if (r // 2) % 2 == 0 else 0] = 1
    m[0, 0] = 1
    got = tmorph.remove_small_components(torch.from_numpy(m), 3).numpy()
    np.testing.assert_array_equal(got, m)
    assert len(np.unique(tmorph.connected_components(torch.from_numpy(m)).numpy())) == 2
