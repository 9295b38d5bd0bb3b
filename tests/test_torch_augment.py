"""The port's training augmentation and clip transforms
(timetuning_tpu_torch/data/transforms.py) against the JAX package's on the
same inputs and the same drawn values, at tiny sizes in f32.

Each op alone, then ``apply_augment`` on the values that a JAX key draws
inside ``augment_batch`` (the test mirrors the key's splits with
``jax.random`` and hands the values to the port). Tolerances: 1e-6 absolute
on [0, 1] values for the photometric ops (bit-level formulas; XLA and torch
may round an exp, a division or a sum in another order by one ulp), 1e-5 on
the resampled outputs in [0, 1] (the port folds the blur and the crop into
one matrix product per axis, which sums in another order), 5e-5 on the
whole chain's normalised output: on these noise frames the JAX package's own
jitted and eager crop-resize differ by 3.2e-6, and the jitter factor (up to
1.8) and the /std normalisation (4.4) scale that."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetuning_tpu.data import transforms as jt
from timetuning_tpu_torch.data import transforms as tt

PHOTO = dict(rtol=0, atol=1e-6)
GEO = dict(rtol=0, atol=1e-5)
CHAIN = dict(rtol=0, atol=5e-5)


def _frames(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _f32(frames):
    return frames.astype(np.float32) / 255.0


@pytest.mark.parametrize("f", [0.3, 1.0, 1.7])
def test_brightness_and_saturation(f):
    x = _f32(_frames((2, 12, 10, 3)))
    np.testing.assert_allclose(tt._adj_brightness(torch.from_numpy(x), f).numpy(),
                               np.asarray(jt._adj_brightness(jnp.asarray(x), f)), **PHOTO)
    np.testing.assert_allclose(tt._adj_saturation(torch.from_numpy(x), f).numpy(),
                               np.asarray(jt._adj_saturation(jnp.asarray(x), f)), **PHOTO)


@pytest.mark.parametrize("means", ["buffer", "native", "mixed"])
def test_contrast_toward_pil_gray_mean(means):
    x = _f32(_frames((3, 16, 12, 3), seed=1))
    m = {"buffer": None, "native": np.array([100.4, 37.5, 200.0], np.float32),
         "mixed": np.array([np.nan, 37.5, np.nan], np.float32)}[means]
    got = tt._adj_contrast(torch.from_numpy(x), 0.6,
                           None if m is None else torch.from_numpy(m))
    want = jt._adj_contrast(jnp.asarray(x), 0.6, None if m is None else jnp.asarray(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PHOTO)
    # the integer means themselves are exact
    np.testing.assert_array_equal(tt._pil_gray_mean(torch.from_numpy(x)).numpy(),
                                  np.asarray(jt._pil_gray_mean(jnp.asarray(x))))


@pytest.mark.parametrize("shift", [-0.2, 0.05, 0.19])
def test_hue_with_wrap(shift):
    x = _f32(_frames((2, 14, 14, 3), seed=2))
    x[0, :4] = x[0, :4, :, :1]          # gray pixels (d == 0)
    x[1, :2] = 0.0                      # black pixels (mx == 0)
    got = tt._adj_hue(torch.from_numpy(x), shift).numpy()
    np.testing.assert_allclose(got, np.asarray(jt._adj_hue(jnp.asarray(x), shift)), **PHOTO)
    h = tt._rgb_to_hsv(torch.from_numpy(x))[0]
    assert float(h.min()) >= 0.0 and float(h.max()) < 1.0


def test_grayscale():
    x = _f32(_frames((2, 8, 8, 3), seed=3))
    np.testing.assert_allclose(tt._grayscale(torch.from_numpy(x)).numpy(),
                               np.asarray(jt._grayscale(jnp.asarray(x))), **PHOTO)


@pytest.mark.parametrize("scaled", [False, True])
def test_blur_per_frame_sigma(scaled):
    """The JAX blur draws its sigmas from the key: the same draws go to the
    port's banded-matrix form; ``scaled`` converts native units to buffer
    pixels per axis (buffer 20 x 24 from a 37 x 61 frame)."""
    cfg = jt.AugmentConfig(blur_ksize=7, blur_p=1.0)
    x = _f32(_frames((3, 20, 24, 3), seed=4))
    key = jax.random.PRNGKey(5)
    sy, sx = (20 / 37.0, 24 / 61.0) if scaled else (None, None)
    want = jt._gaussian_blur(key, jnp.asarray(x), cfg,
                             None if sy is None else jnp.float32(sy),
                             None if sx is None else jnp.float32(sx))
    sigma = jax.random.uniform(jax.random.split(key)[1], (3,), minval=0.1, maxval=2.0)
    sig = torch.from_numpy(np.asarray(sigma))[None]
    on = torch.tensor([True])
    my = tt._blur_matrices(20, sig if sy is None else sig * sy, on, 7)
    mx = tt._blur_matrices(24, sig if sx is None else sig * sx, on, 7)
    got = tt._resample(torch.from_numpy(x)[None], my, mx)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **GEO)


def test_blur_matrix_is_reflect_padded_conv():
    """Small buffers reflect more than once; the matrix still equals the
    padded convolution's taps."""
    x = torch.rand(1, 1, 5, 6, 1)
    sigma, on = torch.tensor([[1.3]]), torch.tensor([True])
    got = tt._resample(x, tt._blur_matrices(5, sigma, on, 9),
                       tt._blur_matrices(6, sigma, on, 9))
    k = np.exp(-((np.arange(9) - 4.0) ** 2) / (2 * 1.3 ** 2))
    k /= k.sum()
    pad = np.pad(x[0, 0, :, :, 0].numpy().astype(np.float64), 4, mode="reflect")
    rows = sum(k[t] * pad[t:t + 5] for t in range(9))
    want = sum(k[t] * rows[:, t:t + 6] for t in range(9))
    np.testing.assert_allclose(got[0, 0, :, :, 0].numpy(), want, atol=1e-6)


def _rrc_draws(key):
    keys = jax.random.split(key, 4)
    cfg = jt.AugmentConfig()
    scale = jax.random.uniform(keys[0], (10,), minval=cfg.crop_scale[0], maxval=cfg.crop_scale[1])
    log_r = jax.random.uniform(keys[1], (10,), minval=np.log(cfg.crop_ratio[0]),
                               maxval=np.log(cfg.crop_ratio[1]))
    return (np.asarray(scale), np.asarray(log_r),
            np.asarray(jax.random.uniform(keys[2], ())), np.asarray(jax.random.uniform(keys[3], ())))


@pytest.mark.parametrize("hw", [(256, 256), (224, 398), (60, 500), (500, 60)])
def test_rrc_box_from_drawn_tries(hw):
    """The box from the same ten tries; (60, 500) and (500, 60) have no
    valid try at these draws for the tall/wide extremes, so they take the
    ratio-clamped center crop (checked)."""
    h, w = hw
    cfg = jt.AugmentConfig()
    key = jax.random.PRNGKey(11)
    want = [float(v) for v in jt._sample_rrc_box(key, h, w, cfg)]
    scale, log_r, iu, ju = _rrc_draws(key)
    got = tt._sample_rrc_box(torch.from_numpy(scale)[None], torch.from_numpy(log_r)[None],
                             torch.tensor([float(iu)]), torch.tensor([float(ju)]),
                             torch.tensor([float(h)]), torch.tensor([float(w)]), cfg)
    np.testing.assert_allclose([float(v) for v in got], want, rtol=1e-6)
    if h != w and max(h, w) / min(h, w) > 4:
        ratio = np.exp(log_r)
        tw, th = np.sqrt(scale * h * w * ratio), np.sqrt(scale * h * w / ratio)
        assert not ((tw <= w) & (th <= h)).any()        # the fallback branch ran


def test_rrc_fallback_with_no_valid_try():
    """Tries that never fit (scale 1 and extreme ratios on a square) take
    the center crop in both packages."""
    cfg = jt.AugmentConfig()
    scale = np.ones((1, 10), np.float32)
    log_r = np.full((1, 10), np.log(1.3), np.float32)
    got = tt._sample_rrc_box(torch.from_numpy(scale), torch.from_numpy(log_r),
                             torch.tensor([0.3]), torch.tensor([0.7]),
                             torch.tensor([100.0]), torch.tensor([100.0]), cfg)
    assert [float(v) for v in got] == [0.0, 0.0, 100.0, 100.0]


@pytest.mark.parametrize("box", [
    (2.0, 3.0, 10.0, 12.0),        # upscaled to 16
    (0.5, 1.0, 30.0, 34.0),        # downscaled (antialiased)
    (25.0, 28.0, 12.0, 9.0),       # cut at the bottom-right edge
    (0.0, 0.0, 37.0, 11.5),        # non-square, fractional
])
def test_crop_resize_frames(box):
    x = _f32(_frames((2, 37, 40, 3), seed=6))
    i, j, ch, cw = box
    want = jt._crop_resize_frames(jnp.asarray(x), jnp.float32(i), jnp.float32(j),
                                  jnp.float32(ch), jnp.float32(cw), 16)
    got = tt._crop_resize_frames(torch.from_numpy(x)[None], *(torch.tensor([v]) for v in box), 16)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **GEO)


def test_crop_resize_frames_folds_blur_and_flip():
    """The blur's matrices folded into the crop's, and a flipped clip beside
    an unflipped one, as ``apply_augment`` calls it: JAX's blur, then its
    crop-resize, then the flip."""
    cfg = jt.AugmentConfig(blur_ksize=7, blur_p=1.0)
    x = _f32(_frames((2, 3, 20, 24, 3), seed=8))
    boxes = [(1.0, 2.5, 14.0, 17.0), (3.0, 0.0, 16.0, 24.0)]
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    sig = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
        jax.random.split(k)[1], (3,), minval=0.1, maxval=2.0)) for k in keys]))
    on = torch.tensor([True, True])
    got = tt._crop_resize_frames(torch.from_numpy(x), *(torch.tensor(v) for v in zip(*boxes)),
                                 12, torch.tensor([False, True]),
                                 tt._blur_matrices(20, sig, on, 7),
                                 tt._blur_matrices(24, sig, on, 7))
    for b, (box, flip) in enumerate(zip(boxes, (False, True))):
        blurred = jt._gaussian_blur(keys[b], jnp.asarray(x[b]), cfg)
        want = np.asarray(jt._crop_resize_frames(blurred, *(jnp.float32(v) for v in box), 12))
        if flip:
            want = want[:, :, ::-1]
        np.testing.assert_allclose(got[b].numpy(), want, **GEO)


def test_crop_resize_nearest_and_flip():
    a = np.random.default_rng(7).integers(0, 5, (2, 3, 30, 26)).astype(np.uint8)
    boxes = [(1.5, 2.0, 20.0, 14.0), (10.0, 0.0, 17.0, 26.0)]
    got = tt._crop_resize_nearest(torch.from_numpy(a), *(torch.tensor(v) for v in zip(*boxes)),
                                  12, flip=torch.tensor([False, True]))
    for b, (box, flip) in enumerate(zip(boxes, (False, True))):
        want = np.asarray(jt._crop_resize_nearest(jnp.asarray(a[b]), *(jnp.float32(v) for v in box), 12))
        if flip:
            want = want[:, :, ::-1]
        np.testing.assert_array_equal(got[b].numpy(), want)


def test_reference_resize_geometry():
    h0 = np.array([480, 720, 300], np.float32)
    w0 = np.array([854, 405, 300], np.float32)
    want = jt.reference_resize_geometry(jnp.asarray(h0), jnp.asarray(w0), 224)
    got = tt.reference_resize_geometry(torch.from_numpy(h0), torch.from_numpy(w0), 224)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def jax_params(key, B, F, cfg):
    """The values ``augment_batch(key, ...)`` draws, by its key splits."""
    vals = {k: [] for k in ("brightness", "contrast", "saturation", "hue", "op", "jitter",
                            "gray", "blur", "flip", "crop_i", "crop_j", "sigma",
                            "crop_scale", "crop_log_ratio")}
    U = jax.random.uniform
    for kclip in jax.random.split(key, B):
        kphoto1, kphoto2, kphoto3, kgeo, kflip = jax.random.split(kclip, 5)
        kb, kc, ks, kh, kop, kapply = jax.random.split(kphoto1, 6)
        vals["brightness"].append(U(kb, (), minval=max(0.0, 1 - cfg.brightness), maxval=1 + cfg.brightness))
        vals["contrast"].append(U(kc, (), minval=max(0.0, 1 - cfg.contrast), maxval=1 + cfg.contrast))
        vals["saturation"].append(U(ks, (), minval=max(0.0, 1 - cfg.saturation), maxval=1 + cfg.saturation))
        vals["hue"].append(U(kh, (), minval=-cfg.hue, maxval=cfg.hue))
        vals["op"].append(jax.random.randint(kop, (), 0, 4))
        vals["jitter"].append(U(kapply) < cfg.jitter_p)
        vals["gray"].append(U(kphoto2) < cfg.grayscale_p)
        kp, ksig = jax.random.split(kphoto3)
        vals["sigma"].append(U(ksig, (F,), minval=cfg.blur_sigma[0], maxval=cfg.blur_sigma[1]))
        vals["blur"].append(U(kp) < cfg.blur_p)
        scale, log_r, iu, ju = _rrc_draws(kgeo)
        vals["crop_scale"].append(scale)
        vals["crop_log_ratio"].append(log_r)
        vals["crop_i"].append(iu)
        vals["crop_j"].append(ju)
        vals["flip"].append(U(kflip) < cfg.hflip_p)
    return tt.AugmentParams.build(**{k: np.stack([np.asarray(v) for v in vs])
                                     for k, vs in vals.items()})


def _tcfg(out):
    return tt.AugmentConfig(out_size=out)


@pytest.mark.parametrize("native", [False, True])
def test_apply_augment_matches_augment_batch(native):
    """``apply_augment`` on JAX's own draws equals ``augment_batch`` at
    the same key, annotations included: 8 clips of 3 frames, a 40 x 48
    buffer to 24, native sizes of mixed aspect and gray means with a NaN
    (the buffer's own mean then)."""
    B, F = 8, 3
    frames = _frames((B, F, 40, 48, 3), seed=8)
    ann = np.random.default_rng(9).integers(0, 4, (B, F, 40, 48)).astype(np.uint8)
    sizes = np.array([[480, 854], [720, 405], [64, 64], [300, 500]] * 2, np.int32)
    gmeans = np.random.default_rng(10).uniform(20, 230, (B, F)).astype(np.float32)
    gmeans[1, 2] = np.nan
    key = jax.random.PRNGKey(3)
    kw = dict(src_sizes=jnp.asarray(sizes), gray_means=jnp.asarray(gmeans)) if native else {}
    want, want_ann = jt.augment_batch(key, jnp.asarray(frames), jnp.asarray(ann),
                                      jt.AugmentConfig(out_size=24), **kw)
    params = jax_params(key, B, F, jt.AugmentConfig())
    ops = params.column("op")[params.column("jitter") > 0].long().tolist()
    assert len(set(ops)) >= 3, ops                     # several ops are covered
    got, got_ann = tt.apply_augment(
        torch.from_numpy(frames), params, _tcfg(24),
        torch.from_numpy(sizes) if native else None,
        torch.from_numpy(gmeans) if native else None, torch.from_numpy(ann))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN)
    np.testing.assert_array_equal(got_ann.numpy(), np.asarray(want_ann))


def test_augment_batch_draws_from_the_generator():
    frames = torch.from_numpy(_frames((3, 2, 20, 20, 3), seed=12))
    a, _ = tt.augment_batch(torch.Generator().manual_seed(4), frames, None, _tcfg(16))
    b, _ = tt.augment_batch(torch.Generator().manual_seed(4), frames, None, _tcfg(16))
    c, _ = tt.augment_batch(torch.Generator().manual_seed(5), frames, None, _tcfg(16))
    assert a.shape == (3, 2, 16, 16, 3) and torch.equal(a, b) and not torch.equal(a, c)
    one, _ = tt.augment_clip(torch.Generator().manual_seed(4), frames[0], None, _tcfg(16))
    assert one.shape == (2, 16, 16, 3) and torch.isfinite(one).all()


def _dispatch_count(fn):
    """aten ops dispatched while ``fn`` runs (a CPU stand-in for kernel
    launches: each op launches its kernel once on the card)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def test_apply_augment_launches_do_not_grow_with_batch():
    """The same number of ops at 8 and at 32 clips: no loop over clips. A
    first call fills the per-device constant caches (the normalisation's
    mean and std, the blur's tap indices) and is not counted."""
    cfg = _tcfg(16)
    warm = torch.from_numpy(_frames((2, 2, 20, 24, 3)))
    tt.apply_augment(warm, tt.draw_augment_params(None, 2, 2, cfg), cfg)
    counts = []
    for B in (8, 32):
        frames = torch.from_numpy(_frames((B, 2, 20, 24, 3), seed=B))
        params = tt.draw_augment_params(torch.Generator().manual_seed(0), B, 2, cfg)
        sizes = torch.tensor([[480, 854]] * B)
        counts.append(_dispatch_count(
            lambda: tt.apply_augment(frames, params, cfg, sizes, torch.full((B, 2), 90.0))))
    assert counts[0] == counts[1], counts


# ------------------------------------------------------------------ #
# the clip transforms (transforms.py:416-520)

def test_flips_crops_rot90():
    c = _frames((2, 9, 11, 3), seed=13)
    t = torch.from_numpy(c)
    for name in ("vertical_flip", "horizontal_flip"):
        np.testing.assert_array_equal(getattr(tt, name)(t).numpy(),
                                      np.asarray(getattr(jt, name)(jnp.asarray(c))))
    np.testing.assert_array_equal(tt.center_crop(t, 5).numpy(),
                                  np.asarray(jt.center_crop(jnp.asarray(c), 5)))
    for k in (1, 2, 3):
        np.testing.assert_array_equal(tt.rotate90(t, k).numpy(),
                                      np.asarray(jt.rotate90(jnp.asarray(c), k)))
    key = jax.random.PRNGKey(2)
    ky, kx = jax.random.split(key)
    y0 = int(jax.random.randint(ky, (), 0, 9 - 4 + 1))
    x0 = int(jax.random.randint(kx, (), 0, 11 - 4 + 1))
    np.testing.assert_array_equal(tt.crop(t, y0, x0, 4).numpy(),
                                  np.asarray(jt.random_crop(key, jnp.asarray(c), 4)))
    assert tt.random_crop(t, 4, torch.Generator().manual_seed(0)).shape == (2, 4, 4, 3)


@pytest.mark.parametrize("out_size", [None, 8])
def test_random_resize(out_size):
    c = _f32(_frames((2, 12, 18, 3), seed=14))
    key = jax.random.PRNGKey(4)
    s = float(jax.random.uniform(key, (), minval=0.5, maxval=1.5))
    want = jt.random_resize(key, jnp.asarray(c), (0.5, 1.5), out_size)
    got = tt.resize_clip(torch.from_numpy(c), s, out_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEO)
    assert tt.random_resize(torch.from_numpy(c), (0.5, 1.5),
                            torch.Generator().manual_seed(0), out_size).dim() == 4


@pytest.mark.parametrize("degrees", [15, (-40.0, -10.0)])
def test_random_rotation(degrees):
    c = _frames((2, 13, 10, 3), seed=15)
    ann = np.random.default_rng(16).integers(0, 3, (2, 13, 10)).astype(np.uint8)
    key = jax.random.PRNGKey(6)
    lo, hi = (-degrees, degrees) if isinstance(degrees, int) else degrees
    angle = float(jax.random.uniform(key, (), minval=lo, maxval=hi))
    want, want_ann = jt.random_rotation(key, jnp.asarray(c), degrees, jnp.asarray(ann))
    got, got_ann = tt.rotate_clip(torch.from_numpy(c), angle, torch.from_numpy(ann))
    # frames stay in 0-255 here: 1e-3 is the f32 rounding of the bilinear
    # sum (4e-6 relative) at that scale
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got_ann.numpy(), np.asarray(want_ann))
    assert math.isfinite(float(tt.random_rotation(
        torch.from_numpy(c), degrees, torch.Generator().manual_seed(0)).sum()))
