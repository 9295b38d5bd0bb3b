"""The port's eval preprocess (timetuning_tpu_torch/data/transforms.py and
the CPU path of ops/preprocess_cuda.py) and nearest resize against the JAX
package's, on the same numpy-seeded frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetuning_tpu.data import transforms as jtf
from timetuning_tpu.ops import preprocess_pallas as jpp
from timetuning_tpu.ops import resize as jresize
from timetuning_tpu_torch.data import transforms as ttf
from timetuning_tpu_torch.ops import preprocess_cuda as tpc
from timetuning_tpu_torch.ops import resize as tresize

torch.set_num_threads(2)


def _frames(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("n_in,n_out", [(480, 224), (854, 224), (96, 96),
                                        (33, 17), (480, 448), (20, 32)])
def test_resize_weights_copy_equals_original(n_in, n_out):
    np.testing.assert_array_equal(tpc._resize_weights(n_in, n_out),
                                  jpp._resize_weights(n_in, n_out))


@pytest.mark.parametrize("n_in,n_out", [(480, 224), (854, 224), (256, 64),
                                        (33, 17), (96, 96)])
def test_band_tables_rebuild_the_dense_weights(n_in, n_out):
    """The kernel reads (start, taps) bands; they hold every nonzero weight."""
    dense = tpc._resize_weights(n_in, n_out)
    start, taps = tpc._band(dense)
    rebuilt = np.zeros_like(dense)
    for o in range(n_out):
        rebuilt[o, start[o]:start[o] + taps.shape[1]] = taps[o]
    np.testing.assert_array_equal(rebuilt, dense)
    assert taps.shape[1] <= 2 * int(np.ceil(n_in / n_out)) + 2


@pytest.mark.parametrize("h,w,s,std", [
    (60, 107, 28, jtf.REFERENCE_STD),      # DAVIS-like downscale geometry
    (64, 64, 48, jtf.IMAGENET_STD),        # square
    (40, 72, 40, jtf.REFERENCE_STD),       # one axis at native size
    (20, 30, 32, jtf.REFERENCE_STD),       # upscale
])
def test_f32_path_matches_jax(h, w, s, std):
    frames = _frames((2, 3, h, w, 3), seed=h)
    want = jtf.eval_preprocess_batch(jnp.asarray(frames), out_size=s, std=std,
                                     compute_dtype=jnp.float32)
    got = ttf.eval_preprocess_batch(torch.from_numpy(frames), out_size=s, std=std)
    assert got.dtype == torch.float32 and got.shape == (2, 3, s, s, 3)
    # the weights are the same matrix built in f64 here and in f32 inside
    # jax.image.resize (drift up to ~2e-5, tests/test_preprocess_pallas.py)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("h,w,s", [(60, 107, 28), (96, 160, 48), (128, 128, 64)])
def test_bf16_path_matches_pallas_kernel_interpret(h, w, s):
    """uint8 shrunk to bf16 takes the kernel wrapper (its plain version on
    the CPU); the TPU kernel quantises its H-pass weights to 8 bits, which
    lands at bf16 rounding (0.0209, preprocess_pallas.py:39-42) for shrinks
    of 2x and more, the eval's 480 -> 224. (At a mild 64 -> 48 its
    quantised weights drift to 0.042 from the f32 path; the port's plain
    version stays within one bf16 rounding there.)"""
    frames = _frames((3, h, w, 3), seed=s)
    want = jpp.eval_preprocess_pallas(jnp.asarray(frames), s, jtf.IMAGENET_MEAN,
                                      jtf.REFERENCE_STD, interpret=True)
    got = ttf.eval_preprocess_batch(torch.from_numpy(frames), out_size=s,
                                    compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=3e-2)


def test_flat_entry_views_and_validates():
    frames = _frames((2, 30, 50, 3))
    flat = torch.from_numpy(frames.reshape(2, 30, 150))
    got = ttf.eval_preprocess_flat(flat, (30, 50), out_size=24)
    want = ttf.eval_preprocess_batch(torch.from_numpy(frames), out_size=24)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="src_hw"):
        ttf.eval_preprocess_flat(flat, (30, 49), out_size=24)


def test_kernel_gate():
    assert tpc.preprocess_cuda_available(480, 854, 224, torch.uint8, torch.bfloat16)
    assert not tpc.preprocess_cuda_available(480, 854, 224, torch.uint8, torch.float32)
    assert not tpc.preprocess_cuda_available(480, 854, 224, torch.float32,
                                             torch.bfloat16)
    assert not tpc.preprocess_cuda_available(200, 854, 224, torch.uint8,
                                             torch.bfloat16)
    with pytest.raises(ValueError, match="uint8"):
        tpc.eval_preprocess_cuda(torch.zeros(1, 8, 8, 3, device="meta"), 4,
                                 jtf.IMAGENET_MEAN, jtf.REFERENCE_STD)


@pytest.mark.parametrize("src,dst", [((64, 64), (224, 224)), ((256, 256), (224, 224)),
                                     ((48, 48), (14, 14)), ((480, 854), (224, 224)),
                                     ((7, 5), (16, 3))])
def test_resize_nearest_matches_jax_half_pixel(src, dst):
    """jax.image.resize 'nearest' samples at half-pixel centres; torch's
    mode='nearest' does not (ROADMAP port-fault log)."""
    x = np.arange(2 * src[0] * src[1], dtype=np.float32).reshape((2,) + src)
    want = jresize.resize_nearest(jnp.asarray(x), dst)
    got = tresize.resize_nearest(torch.from_numpy(x), dst)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(
        np.asarray(jax.image.resize(jnp.asarray(x), (2,) + dst, "nearest")),
        got.numpy())
