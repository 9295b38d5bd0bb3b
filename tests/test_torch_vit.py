"""The port's ViT (timetuning_tpu_torch/models/vit.py) against the JAX
package's on the same weights (carried over by models/convert.py) and the
same numpy-seeded inputs, plus the copied resize matrices pinned to their
originals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetuning_tpu.models.vit import ViTConfig as JViTConfig
from timetuning_tpu.models.vit import VisionTransformer as JViT
from timetuning_tpu.models.vit import interpolate_pos_embed as j_interp
from timetuning_tpu.ops import resize as jresize
from timetuning_tpu_torch.models.convert import vit_state_dict_from_jax
from timetuning_tpu_torch.models.registry import get_backbone
from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer
from timetuning_tpu_torch.models.vit import interpolate_pos_embed as t_interp
from timetuning_tpu_torch.ops import resize as tresize

torch.set_num_threads(2)

# the registry's vit-tiny-test configuration
TINY = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, img_size=32)


@pytest.fixture(scope="module")
def jax_params():
    """vit-tiny-test params, every leaf perturbed so biases and LayerNorm
    parameters are not at their trivial init."""
    model = JViT(JViTConfig(**TINY, attn_impl="xla"))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)


def _pair(params, dtype_j=jnp.float32, dtype_t=torch.float32):
    jm = JViT(JViTConfig(**TINY, attn_impl="xla", dtype=dtype_j))
    tm = VisionTransformer(ViTConfig(**TINY, dtype=dtype_t))
    tm.load_state_dict(vit_state_dict_from_jax(params))
    return jm, tm.eval()


@pytest.mark.parametrize("size", [32, 48])
def test_forward_matches_jax_f32(jax_params, size):
    """Native size (32) and a non-native one (48: the 4x4 position grid is
    resampled bicubically to 6x6): tokens, both intermediates and the last
    block's attention probabilities."""
    jm, tm = _pair(jax_params)
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
    want = jm.apply({"params": jax_params}, jnp.asarray(x), want_attention=True,
                    n_intermediates=2)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), want_attention=True, n_intermediates=2)
    assert got["grid"] == want["grid"] == (size // 8, size // 8)
    np.testing.assert_allclose(got["tokens"].numpy(), np.asarray(want["tokens"]),
                               rtol=1e-4, atol=1e-5)
    for g, w in zip(got["intermediates"], want["intermediates"], strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["attention"].numpy(),
                               np.asarray(want["attention"]), rtol=1e-4, atol=1e-5)


def test_forward_bf16_matches_jax_at_bf16_rounding(jax_params):
    """bf16 compute: the port runs the kernel wrappers' plain versions, the
    JAX package (on CPU) its bf16 Flax modules; they round at different
    points, so the bound is bf16 rounding accumulated over two blocks."""
    jm, tm = _pair(jax_params, jnp.bfloat16, torch.bfloat16)
    x = np.random.default_rng(7).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jm.apply({"params": jax_params}, jnp.asarray(x))["tokens"],
                      np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))["tokens"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2, atol=5e-2)
    cos = torch.nn.functional.cosine_similarity(
        got.float(), torch.from_numpy(want), dim=-1)
    assert cos.min().item() > 0.999


@pytest.mark.parametrize("grid", [(4, 4), (6, 6), (3, 5)])
def test_interpolate_pos_embed_matches_jax(jax_params, grid):
    pe = np.array(jax_params["pos_embed"])
    want = j_interp(jnp.asarray(pe), *grid, 8)
    got = t_interp(torch.from_numpy(pe), *grid, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_in,n_out,inv", [(4, 6, None), (14, 28, None),
                                            (14, 16, 14 / 16.1), (6, 3, None)])
def test_cubic_matrix_copy_equals_original(n_in, n_out, inv):
    np.testing.assert_array_equal(tresize._cubic_matrix(n_in, n_out, inv),
                                  jresize._cubic_matrix(n_in, n_out, inv))


@pytest.mark.parametrize("n_in,n_out", [(14, 224), (7, 64), (28, 28), (5, 13)])
def test_bilinear_matrix_copy_equals_original(n_in, n_out):
    np.testing.assert_array_equal(tresize._bilinear_matrix(n_in, n_out),
                                  jresize._bilinear_matrix(n_in, n_out))


@pytest.mark.parametrize("src,dst", [((14, 14), (224, 224)),   # square upscale
                                     ((14, 14), (14, 56)),     # one axis equal
                                     ((20, 10), (12, 30)),     # mixed up/down
                                     ((40, 36), (16, 16))])    # downscale
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.default_rng(0).standard_normal((2, 3) + src).astype(np.float32)
    want = jresize.resize_bilinear(jnp.asarray(x), dst)
    got = tresize.resize_bilinear(torch.from_numpy(x), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_registry_seeded_init_and_shapes():
    """Same seed, same weights; the ViT names of the JAX registry; the
    patch grid of each."""
    a = get_backbone("vit-tiny-test", seed=3, device="cpu").module.state_dict()
    b = get_backbone("vit-tiny-test", seed=3, device="cpu").module.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    bb = get_backbone("vit-tiny-test-p4", device="cpu")
    assert bb.spatial_resolution(64) == 16 and bb.drop_cls
    feats, attn = bb.apply(torch.zeros(1, 64, 64, 3))
    assert feats.shape == (1, 256, 32) and attn is None
    with pytest.raises(ValueError, match="not yet ported"):
        get_backbone("resnet50", device="cpu")


def test_registry_loads_reference_pth(jax_params, tmp_path):
    """A reference-layout .pth (TimeT prefix) loads with load_state_dict."""
    sd = {"feature_extractor.backbone." + k: v
          for k, v in vit_state_dict_from_jax(jax_params).items()}
    path = tmp_path / "w.pth"
    torch.save(sd, path)
    bb = get_backbone("vit-tiny-test", model_path=str(path), device="cpu")
    got = bb.module.state_dict()
    for k, v in vit_state_dict_from_jax(jax_params).items():
        assert torch.equal(got[k], v), k
