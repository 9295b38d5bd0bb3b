"""Preprocessing on the device: the training clip augmentation, the clip
transforms, and the deterministic eval resize + normalise.

Counterpart of ``timetuning_tpu/data/transforms.py`` (reference
video_transformations.py; the training chain of time_tuning.py:587-593:
ColorJitter(0.8, 0.8, 0.8, 0.2) at p 0.8 -> RandomGrayscale -> Gaussian blur,
then Resize -> RandomResizedCrop(scale 0.4-1, ratio 3/4-4/3) ->
RandomHorizontalFlip -> ClipToTensor(mean, std=[.228, .224, .225])).

The JAX package draws every random value of the chain from one key inside
its jitted program; torch has no twin of that key stream. So draw and apply
are split here:

  * ``draw_augment_params(generator, B, F, cfg)`` draws all random values of
    a batch on the host, from a ``torch.Generator``, into one small table
    (``AugmentParams``) that is uploaded with the batch;
  * ``apply_augment(frames_u8, params, cfg, src_sizes, gray_means)`` is
    deterministic and runs on the frames' device. Given the draws the JAX
    key would make (the tests mirror its splits), it computes what
    ``augment_batch`` computes.

``apply_augment`` has no loop over clips, and its launch count does not
depend on the batch size. The jitter op of each clip is chosen by
per-clip factors: brightness, contrast and saturation are the one blend
``clip(a x + c gray(x) + d)``; hue runs on the clips that drew it (their
indices are known on the host). The Gaussian blur and the random resized
crop are both linear along each axis, so they are one matrix a frame and
an axis (the crop's weights times the blur's banded matrix, identity for
clips that do not blur, rows reversed for clips that flip), applied to the
whole batch by two batched products in f32.

The native size of each clip (``src_sizes``) and the PIL gray means of its
native frames (``gray_means``) restore the reference's geometry and
contrast target on top of the square decode buffer, as in the JAX
package's module docstring.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
# The reference's (typo'd) ImageNet std, kept for checkpoint parity
# (time_tuning.py:592).
REFERENCE_STD = (0.228, 0.224, 0.225)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    out_size: int = 224
    crop_scale: tuple[float, float] = (0.4, 1.0)
    crop_ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    hflip_p: float = 0.5
    jitter_p: float = 0.8
    brightness: float = 0.8
    contrast: float = 0.8
    saturation: float = 0.8
    hue: float = 0.2
    grayscale_p: float = 0.2
    blur_p: float = 0.5
    blur_sigma: tuple[float, float] = (0.1, 2.0)
    blur_ksize: int = 23
    mean: tuple[float, float, float] = IMAGENET_MEAN
    std: tuple[float, float, float] = REFERENCE_STD


# --------------------------------------------------------------------- #
# photometric ops (torchvision functional semantics, [..., H, W, 3] in [0, 1])

def _blend(x, factor, target, offset=0.0):
    """``clip(x * factor + target * (1 - factor), 0, 1)`` as the JAX
    ``_blend`` rounds it, with the target's term given as ``c * g + d``:
    ``c = 1 - factor`` and ``d = 0`` for a gray image ``g``, ``c = 0`` and
    ``d = mean * (1 - factor)`` for a solid gray. Adding an exact zero
    changes no value, so one formula serves every op."""
    return torch.clamp(x * factor + target + offset, 0.0, 1.0)


def _grayscale(x):
    g = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    return g[..., None]


def _adj_brightness(x, f):
    return _blend(x, f, 0.0)


def _pil_gray_mean(x):
    """Per-frame grayscale mean in PIL's integer semantics, [0, 255] (the
    JAX ``_pil_gray_mean``): ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``
    per pixel, averaged. Every intermediate stays below 2^24, so f32 holds
    it exactly. x: [..., H, W, 3] floats that are exactly uint8 / 255."""
    u = torch.round(x * 255.0)
    lum = torch.floor(
        (19595.0 * u[..., 0] + 38470.0 * u[..., 1] + 7471.0 * u[..., 2]
         + 32768.0) / 65536.0)
    # the integer sum is exact; XLA divides by the count as a product with
    # its f32 reciprocal
    n = torch.tensor(1.0 / (lum.shape[-1] * lum.shape[-2]), dtype=torch.float32)
    return lum.sum(dim=(-2, -1)) * n.to(lum.device)


def _contrast_offset(mean255, f):
    """``target * (1 - f)``: the blend toward a solid gray of the rounded
    mean (``int(mean + 0.5)``, PIL.ImageEnhance.Contrast)."""
    return (torch.floor(mean255 + 0.5) / 255.0) * (1.0 - f)


def _adj_contrast(x, f, mean255=None):
    """PIL/torchvision ``adjust_contrast`` on [F, H, W, 3]: ``mean255`` are
    per-frame means in [0, 255] taken on the native frame at decode time
    (NaN or None: the mean of ``x`` itself)."""
    own = _pil_gray_mean(x)
    if mean255 is None:
        mean255 = own
    else:
        mean255 = torch.where(torch.isnan(mean255), own, mean255)
    return _blend(x, f, 0.0, _contrast_offset(mean255, f)[..., None, None, None])


def _adj_saturation(x, f):
    return _blend(x, f, _grayscale(x) * (1.0 - f))


def _rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = x.amax(dim=-1)
    mn = x.amin(dim=-1)
    d = mx - mn
    safe = torch.where(d == 0, torch.ones_like(d), d)
    h = torch.where(
        mx == r, (g - b) / safe,
        torch.where(mx == g, 2.0 + (b - r) / safe, 4.0 + (r - g) / safe))
    h = torch.where(d == 0, torch.zeros_like(h), h) / 6.0
    h = torch.remainder(h, 1.0)
    s = torch.where(mx == 0, torch.zeros_like(d),
                    d / torch.where(mx == 0, torch.ones_like(mx), mx))
    return h, s, mx


def _select6(i, a, b, c, d, e, f):
    """``lax.select_n(i, a, ..., f)`` for i in 0..5."""
    out = torch.where(i == 4, e, f)
    for k, v in ((3, d), (2, c), (1, b), (0, a)):
        out = torch.where(i == k, v, out)
    return out


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)
    r = _select6(i, v, q, p, p, t, v)
    g = _select6(i, t, v, v, q, p, p)
    b = _select6(i, p, p, t, v, v, q)
    return torch.stack([r, g, b], dim=-1)


def _adj_hue(x, shift):
    h, s, v = _rgb_to_hsv(x)
    return _hsv_to_rgb(torch.remainder(h + shift, 1.0), s, v)


# --------------------------------------------------------------------- #
# the drawn values of a batch

# per-clip columns of the table, then blur sigma [F], crop scale [10] and
# crop log-ratio [10]
_COLUMNS = ("brightness", "contrast", "saturation", "hue", "op", "jitter",
            "gray", "blur", "flip", "crop_i", "crop_j")
_TRIES = 10        # torchvision RandomResizedCrop's rejection tries


@dataclasses.dataclass
class AugmentParams:
    """Every random value of one batch's augmentation.

    ``table`` [B, 11 + F + 20] f32 holds, per clip: the four jitter factors,
    the jitter op (0 brightness, 1 contrast, 2 saturation, 3 hue), the
    jitter / grayscale / blur / flip decisions as 0 or 1, the crop's two
    position uniforms, then the blur sigma of each frame (native-resolution
    units) and the crop's ten scale and ten log-ratio tries. ``subsets``
    holds the indices of the clips whose applied jitter is contrast, then
    those whose is hue (``n_contrast`` of the first). One table and one
    index tensor: two host-to-device copies a batch."""

    table: torch.Tensor
    subsets: torch.Tensor
    n_contrast: int
    n_frames: int

    @classmethod
    def build(cls, *, brightness, contrast, saturation, hue, op, jitter, gray,
              blur, flip, crop_i, crop_j, sigma, crop_scale, crop_log_ratio):
        """From per-clip values ([B], the decisions as booleans), ``sigma``
        [B, F] and the crop tries [B, 10], as tensors or arrays."""
        cols = [torch.as_tensor(np.asarray(v), dtype=torch.float32).reshape(-1, 1)
                for v in (brightness, contrast, saturation, hue, op, jitter,
                          gray, blur, flip, crop_i, crop_j)]
        sigma = torch.as_tensor(np.asarray(sigma), dtype=torch.float32)
        table = torch.cat(cols + [
            sigma,
            torch.as_tensor(np.asarray(crop_scale), dtype=torch.float32),
            torch.as_tensor(np.asarray(crop_log_ratio), dtype=torch.float32),
        ], dim=1)
        on = table[:, 5] > 0
        op = table[:, 4]
        c_idx = torch.nonzero(on & (op == 1)).flatten()
        h_idx = torch.nonzero(on & (op == 3)).flatten()
        return cls(table, torch.cat([c_idx, h_idx]), int(c_idx.numel()),
                   int(sigma.shape[1]))

    def to(self, device, non_blocking: bool = False) -> "AugmentParams":
        if self.table.device == torch.device(device):
            return self
        return dataclasses.replace(
            self, table=self.table.to(device, non_blocking=non_blocking),
            subsets=self.subsets.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "AugmentParams":
        return dataclasses.replace(self, table=self.table.pin_memory(),
                                   subsets=self.subsets.pin_memory())

    def column(self, name: str) -> torch.Tensor:
        return self.table[:, _COLUMNS.index(name)]

    @property
    def sigma(self) -> torch.Tensor:
        n = len(_COLUMNS)
        return self.table[:, n:n + self.n_frames]

    @property
    def crop_tries(self) -> tuple[torch.Tensor, torch.Tensor]:
        n = len(_COLUMNS) + self.n_frames
        return self.table[:, n:n + _TRIES], self.table[:, n + _TRIES:n + 2 * _TRIES]

    @property
    def contrast_clips(self) -> torch.Tensor:
        return self.subsets[:self.n_contrast]

    @property
    def hue_clips(self) -> torch.Tensor:
        return self.subsets[self.n_contrast:]


def draw_augment_params(generator: torch.Generator | None, B: int, F: int,
                        cfg: AugmentConfig) -> AugmentParams:
    """Draw one batch's augmentation values on the host: for each clip the
    jitter factors and op (the reference applies ONE uniformly chosen op,
    video_transformations.py:768-780), the jitter / grayscale / blur / flip
    decisions, a blur sigma per frame (the reference draws a PIL radius per
    frame, :640) and the crop's ten tries and position, with the JAX
    package's ranges."""

    def uniform(lo, hi, *shape):
        return torch.rand(shape, generator=generator) * (hi - lo) + lo

    def factor(strength):
        return uniform(max(0.0, 1.0 - strength), 1.0 + strength, B)

    brightness = factor(cfg.brightness)
    contrast = factor(cfg.contrast)
    saturation = factor(cfg.saturation)
    hue = uniform(-cfg.hue, cfg.hue, B)
    op = torch.randint(0, 4, (B,), generator=generator)
    jitter = torch.rand(B, generator=generator) < cfg.jitter_p
    gray = torch.rand(B, generator=generator) < cfg.grayscale_p
    sigma = uniform(cfg.blur_sigma[0], cfg.blur_sigma[1], B, F)
    blur = torch.rand(B, generator=generator) < cfg.blur_p
    crop_scale = uniform(cfg.crop_scale[0], cfg.crop_scale[1], B, _TRIES)
    crop_log_ratio = uniform(math.log(cfg.crop_ratio[0]),
                             math.log(cfg.crop_ratio[1]), B, _TRIES)
    crop_i = torch.rand(B, generator=generator)
    crop_j = torch.rand(B, generator=generator)
    flip = torch.rand(B, generator=generator) < cfg.hflip_p
    return AugmentParams.build(
        brightness=brightness, contrast=contrast, saturation=saturation,
        hue=hue, op=op, jitter=jitter, gray=gray, blur=blur, flip=flip,
        crop_i=crop_i, crop_j=crop_j, sigma=sigma, crop_scale=crop_scale,
        crop_log_ratio=crop_log_ratio)


# --------------------------------------------------------------------- #
# geometry: the crop box, and the per-clip resampling matrices

def reference_resize_geometry(h0, w0, size: int):
    """The reference's short-side ``Resize`` output dims (``get_resize_sizes``,
    video_transformations.py:96-103, with its int() truncation): (rh, rw)
    with min(rh, rw) == size and the aspect kept. h0, w0: f32 tensors."""
    size = float(size)
    rh = torch.where(w0 < h0, torch.floor(size * h0 / w0), torch.full_like(h0, size))
    rw = torch.where(w0 < h0, torch.full_like(w0, size), torch.floor(size * w0 / h0))
    return rh, rw


def _sample_rrc_box(scale, log_ratio, iu, ju, h, w, cfg: AugmentConfig):
    """torchvision ``RandomResizedCrop.get_params`` on drawn tries, batched:
    the first of the ten (scale, log-ratio) tries whose box fits, placed at
    (iu, ju) of the free range; if none fits, the ratio-clamped center crop.
    scale, log_ratio [B, 10]; iu, ju, h, w [B] f32. Returns (i, j, ch, cw)."""
    area = h * w
    target_area = scale * area[:, None]
    ratio = torch.exp(log_ratio)
    cw = torch.sqrt(target_area * ratio)
    ch = torch.sqrt(target_area / ratio)
    valid = (cw <= w[:, None]) & (ch <= h[:, None]) & (cw > 0) & (ch > 0)
    pick = valid.to(torch.uint8).argmax(dim=1, keepdim=True)     # first valid
    any_valid = valid.any(dim=1)
    cw_s = cw.gather(1, pick)[:, 0]
    ch_s = ch.gather(1, pick)[:, 0]
    i = iu * (h - ch_s)
    j = ju * (w - cw_s)
    r0, r1 = cfg.crop_ratio
    in_ratio = w / h
    fw = torch.where(in_ratio < r0, w, torch.where(in_ratio > r1, h * r1, w))
    fh = torch.where(in_ratio < r0, w / r0, h)
    fi, fj = (h - fh) / 2.0, (w - fw) / 2.0
    return (torch.where(any_valid, i, fi), torch.where(any_valid, j, fj),
            torch.where(any_valid, ch_s, fh), torch.where(any_valid, cw_s, fw))


def _scale_translate_weights(n_in: int, n_out: int, scale, translation):
    """[B, n_out, n_in] weights of ``jax.image.scale_and_translate``'s
    bilinear kernel along one axis, per row of ``scale`` / ``translation``
    ([B] f32): output pixel p samples input ``(p + 0.5 - t) / scale - 0.5``;
    the triangle widens by 1 / scale when shrinking (antialias); a column is
    divided by its sum over the taps that lie in the input, and set to zero
    where the sample point lies outside [-0.5, n_in - 0.5]
    (``jax._src.image.scale.compute_weight_mat``)."""
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5)
                * inv_scale[:, None] - (translation * inv_scale)[:, None] - 0.5)
    x = torch.abs(sample_f[:, None, :]
                  - torch.arange(n_in, dtype=torch.float32, device=dev)[None, :, None]
                  ) / kernel_scale[:, None, None]                # [B, in, out]
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = torch.where(inside[:, None, :], w, torch.zeros_like(w))
    return w.transpose(1, 2)


def _crop_weights(n_in: int, out: int, start, size):
    """The crop [start, start + size) of one axis resized to ``out``
    (``_crop_resize_frames``: scale out / size, translation -start * scale)."""
    scale = out / size
    return _scale_translate_weights(n_in, out, scale, -start * scale)


@functools.lru_cache(maxsize=32)
def _reflect_taps(n: int, ksize: int, device: torch.device) -> torch.Tensor:
    """[n, ksize] input index of each tap of each output under
    ``jnp.pad(mode="reflect")`` by ksize // 2 (repeated reflection), kept
    on ``device`` (a copy from pageable host memory waits for the device)."""
    pos = np.arange(n)[:, None] + np.arange(ksize)[None, :] - ksize // 2
    if n == 1:
        return torch.zeros(pos.shape, dtype=torch.int64, device=device)
    period = 2 * (n - 1)
    m = np.abs(pos) % period
    return torch.from_numpy(np.where(m >= n, period - m, m)).to(device)


@functools.lru_cache(maxsize=32)
def _constant(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _blur_matrices(n: int, sigma, do_blur, ksize: int):
    """[B, F, n, n] banded matrices of the separable Gaussian blur along one
    axis with reflect padding (the JAX ``_gaussian_blur``'s kernel: taps
    ``exp(-r^2 / (2 sigma^2))`` normalised), one per frame; the identity for
    clips with ``do_blur`` false. sigma [B, F] in this axis's pixels."""
    B, F = sigma.shape
    dev = sigma.device
    r = torch.arange(ksize, dtype=torch.float32, device=dev) - (ksize - 1) / 2
    k = torch.exp(-(r ** 2) / (2.0 * sigma[..., None] ** 2))
    k = k / k.sum(dim=-1, keepdim=True)
    delta = torch.zeros(ksize, dtype=torch.float32, device=dev)
    delta[ksize // 2] = 1.0
    k = torch.where(do_blur[:, None, None], k, delta)
    idx = _reflect_taps(n, ksize, dev)
    out = torch.zeros(B, F, n, n, dtype=torch.float32, device=dev)
    return out.scatter_add_(-1, idx.expand(B, F, n, ksize),
                            k[:, :, None, :].expand(B, F, n, ksize))


def _resample(x, my, mx):
    """x [B, F, H, W, C] -> [B, F, oh, ow, C] = my @ x @ mx^T per frame and
    channel; my [B, F, oh, H], mx [B, F, ow, W] (f32 products)."""
    B, F, H, W, C = x.shape
    oh, ow = my.shape[-2], mx.shape[-2]
    t = torch.matmul(my, x.reshape(B, F, H, W * C)).reshape(B, F, oh, W, C)
    t = t.transpose(2, 3).reshape(B, F, W, oh * C)
    out = torch.matmul(mx, t).reshape(B, F, ow, oh, C)
    return out.transpose(2, 3)


def _crop_resize_frames(x, i, j, ch, cw, out: int, flip=None, pre_y=None,
                        pre_x=None):
    """Bilinear crop + resize of [B, F, H, W, C] to ``out`` x ``out`` per clip
    box (i, j, ch, cw [B]): ``jax.image.scale_and_translate``. ``flip`` [B]
    reverses a clip's columns; ``pre_y`` / ``pre_x`` [B, F, n, n] are linear
    maps of each frame's axis applied before the crop (the blur), folded
    into its matrices."""
    H, W = x.shape[2:4]
    wy = _crop_weights(H, out, i, ch)
    wx = _crop_weights(W, out, j, cw)
    if flip is not None:
        wx = torch.where(flip[:, None, None], wx.flip(1), wx)
    wy, wx = wy[:, None], wx[:, None]
    if pre_y is not None:
        wy = torch.matmul(wy, pre_y)
    if pre_x is not None:
        wx = torch.matmul(wx, pre_x)
    return _resample(x, wy, wx)


def _nearest_rows(n_in: int, out: int, start, size):
    pos = start[:, None] + (torch.arange(out, dtype=torch.float32,
                                         device=start.device) + 0.5) \
        * (size / out)[:, None] - 0.5
    return torch.clamp(torch.round(pos), 0, n_in - 1).long()


def _crop_resize_nearest(x, i, j, ch, cw, out: int, flip=None):
    """Nearest gather of integer maps [B, F, H, W] per clip box (the
    annotations' co-transform); ``flip`` [B] reverses a clip's columns."""
    B, F, H, W = x.shape
    yi = _nearest_rows(H, out, i, ch)
    xi = _nearest_rows(W, out, j, cw)
    if flip is not None:
        xi = torch.where(flip[:, None], xi.flip(1), xi)
    x = x.gather(2, yi[:, None, :, None].expand(B, F, out, W))
    return x.gather(3, xi[:, None, None, :].expand(B, F, out, out))


# --------------------------------------------------------------------- #

def apply_augment(frames, params: AugmentParams, cfg: AugmentConfig,
                  src_sizes=None, gray_means=None, annotations=None):
    """Augment a batch with drawn values: frames [B, F, H, W, 3] uint8 on
    any device; ``params`` from ``draw_augment_params`` (moved to the
    frames' device here if it is not there); ``src_sizes`` [B, 2] the
    native (H0, W0) of each clip; ``gray_means`` [B, F] the native frames'
    PIL gray means (NaN: the buffer's own); ``annotations`` [B, F, H, W]
    integer maps. Returns (normalised f32 [B, F, out, out, 3], annotations
    [B, F, out, out] or None)."""
    B, F, H, W, _ = frames.shape
    dev = frames.device
    p = params.to(dev)
    x = frames.float() / 255.0

    if src_sizes is None:
        geo_h = torch.full((B,), float(H), device=dev)
        geo_w = torch.full((B,), float(W), device=dev)
        box_y = box_x = torch.ones(B, device=dev)
        blur_y = blur_x = None
    else:
        sizes = torch.as_tensor(src_sizes).to(dev, torch.float32)
        h0, w0 = sizes[:, 0], sizes[:, 1]
        blur_y, blur_x = H / h0, W / w0
        geo_h, geo_w = reference_resize_geometry(h0, w0, cfg.out_size)
        box_y, box_x = H / geo_h, W / geo_w

    # colour jitter: one op a clip, applied to the original frame
    # (video_transformations.py:768-780)
    jit, op = p.column("jitter") > 0, p.column("op")
    is_b, is_c, is_s = jit & (op == 0), jit & (op == 1), jit & (op == 2)
    fc, fs = p.column("contrast"), p.column("saturation")
    one = torch.ones_like(fc)
    a = torch.where(is_b, p.column("brightness"),
                    torch.where(is_c, fc, torch.where(is_s, fs, one)))
    c = torch.where(is_s, 1.0 - fs, torch.zeros_like(fs))
    if gray_means is None:
        mean255 = torch.full((B, F), float("nan"), device=dev)
    else:
        mean255 = torch.as_tensor(gray_means).to(dev, torch.float32)
    c_idx = p.contrast_clips
    own = torch.zeros(B, F, device=dev).index_copy_(
        0, c_idx, _pil_gray_mean(x.index_select(0, c_idx)))
    mean255 = torch.where(torch.isnan(mean255), own, mean255)
    d = torch.where(is_c[:, None], _contrast_offset(mean255, fc[:, None]),
                    torch.zeros_like(mean255))
    y = _blend(x, a.view(B, 1, 1, 1, 1), _grayscale(x) * c.view(B, 1, 1, 1, 1),
               d.view(B, F, 1, 1, 1))
    h_idx = p.hue_clips
    y.index_copy_(0, h_idx, _adj_hue(x.index_select(0, h_idx),
                                     p.column("hue")[h_idx].view(-1, 1, 1, 1)))
    x = torch.where(p.column("gray").view(B, 1, 1, 1, 1) > 0,
                    _grayscale(y).expand_as(y), y)

    # blur, crop + resize and flip: one matrix a frame and an axis
    scale, log_ratio = p.crop_tries
    i, j, ch, cw = _sample_rrc_box(scale, log_ratio, p.column("crop_i"),
                                   p.column("crop_j"), geo_h, geo_w, cfg)
    i, j, ch, cw = i * box_y, j * box_x, ch * box_y, cw * box_x
    flip = p.column("flip") > 0
    sigma, do_blur = p.sigma, p.column("blur") > 0
    sy = sigma if blur_y is None else sigma * blur_y[:, None]
    sx = sigma if blur_x is None else sigma * blur_x[:, None]
    x = _crop_resize_frames(x, i, j, ch, cw, cfg.out_size, flip,
                            _blur_matrices(H, sy, do_blur, cfg.blur_ksize),
                            _blur_matrices(W, sx, do_blur, cfg.blur_ksize))

    x = (torch.clamp(x, 0.0, 1.0) - _constant(cfg.mean, dev)) / _constant(cfg.std, dev)

    ann_out = None
    if annotations is not None:
        ann_out = _crop_resize_nearest(torch.as_tensor(annotations).to(dev),
                                       i, j, ch, cw, cfg.out_size, flip)
    return x, ann_out


def augment_batch(generator, frames, annotations, cfg: AugmentConfig,
                  with_annotations: bool = True, src_sizes=None,
                  gray_means=None):
    """Draw and apply in one call (the JAX ``augment_batch`` signature with a
    ``torch.Generator`` for the key). frames [B, F, H, W, 3] uint8."""
    B, F = frames.shape[:2]
    params = draw_augment_params(generator, B, F, cfg)
    ann = annotations if with_annotations else None
    return apply_augment(frames, params, cfg, src_sizes, gray_means, ann)


def augment_clip(generator, frames, annotations, cfg: AugmentConfig,
                 src_size=None, gray_means=None):
    """One clip: frames [F, H, W, 3] uint8, annotations [F, H, W] or None,
    src_size [2], gray_means [F]."""
    out, ann = augment_batch(
        generator, frames[None],
        None if annotations is None else annotations[None], cfg,
        annotations is not None,
        None if src_size is None else torch.as_tensor(src_size)[None],
        None if gray_means is None else torch.as_tensor(gray_means)[None])
    return out[0], None if ann is None else ann[0]


# ------------------------------------------------------------------ #
# clip transforms of the reference that the training chain does not use
# (video_transformations.py: RandomVerticalFlip :199-237, CenterCrop
# :559-601, RandomCrop :373-419, RandomResize :322-349, RandomRotation
# :517-556). Clip-consistent on [F, H, W, C] or [F, H, W]. Each random one
# is a draw (from a torch.Generator) and a deterministic apply.


def vertical_flip(clip):
    return clip.flip(1)


def horizontal_flip(clip):
    return clip.flip(2)


def center_crop(clip, size: int):
    H, W = clip.shape[1:3]
    y0 = (H - size) // 2
    x0 = (W - size) // 2
    return clip[:, y0:y0 + size, x0:x0 + size]


def crop(clip, y0: int, x0: int, size: int):
    return clip[:, y0:y0 + size, x0:x0 + size]


def random_crop(clip, size: int, generator=None):
    H, W = clip.shape[1:3]
    y0 = int(torch.randint(0, H - size + 1, (), generator=generator))
    x0 = int(torch.randint(0, W - size + 1, (), generator=generator))
    return crop(clip, y0, x0, size)


def _resize_axis(x, dim: int, n_out: int):
    """``jax.image.resize`` bilinear (antialiased) along one axis."""
    n_in = x.shape[dim]
    if n_out == n_in:
        return x
    scale = torch.tensor([n_out / n_in], dtype=torch.float32, device=x.device)
    w = _scale_translate_weights(n_in, n_out, scale, torch.zeros_like(scale))[0]
    return torch.movedim(torch.tensordot(w, x.movedim(dim, 0), dims=1), 0, dim)


def resize_clip(clip, s: float, out_size: int | None = None):
    """The apply half of ``RandomResize``: every frame of [F, H, W, (C)]
    to ``(round(H s), round(W s))`` bilinearly, then optionally to
    ``out_size`` square."""
    H, W = clip.shape[1:3]
    new_h, new_w = max(int(round(H * s)), 1), max(int(round(W * s)), 1)
    out = _resize_axis(_resize_axis(clip.float(), 1, new_h), 2, new_w)
    if out_size is not None:
        out = _resize_axis(_resize_axis(out, 1, out_size), 2, out_size)
    return out


def random_resize(clip, ratio: tuple[float, float], generator=None,
                  out_size: int | None = None):
    """The reference ``RandomResize``: one scale drawn uniformly from
    ``ratio`` for the clip (video_transformations.py:322-349)."""
    s = float(torch.rand((), generator=generator) * (ratio[1] - ratio[0]) + ratio[0])
    return resize_clip(clip, s, out_size)


def rotate90(clip, k: int = 1):
    return torch.rot90(clip, k=k, dims=(1, 2))


def _round_half_away(x):
    r = torch.round(x)
    t = torch.trunc(x)
    return torch.where(torch.abs(x - t) == 0.5, t + torch.sign(x), r)


def _rotate_planes(planes, angle_rad: float, order: int):
    """Rotate [..., H, W] planes by ``angle_rad`` (CCW), constant-0 fill,
    shape kept: ``jax.scipy.ndimage.map_coordinates`` at the inverse-mapped
    coordinates, bilinear (order 1) or nearest (order 0, half away from
    zero)."""
    H, W = planes.shape[-2:]
    dev = planes.device
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    yo, xo = yy - cy, xx - cx
    ang = torch.tensor(-angle_rad, dtype=torch.float32)
    c, s = float(torch.cos(ang)), float(torch.sin(ang))
    c, s = torch.tensor(c, device=dev), torch.tensor(s, device=dev)
    yin = cy + c * yo - s * xo
    xin = cx + s * yo + c * xo
    flat = planes.reshape(-1, H * W)

    def nodes(coord):
        if order == 0:
            return [(_round_half_away(coord).long(), None)]
        lo = torch.floor(coord)
        up = coord - lo
        return [(lo.long(), 1 - up), (lo.long() + 1, up)]

    out = None
    for iy, wy in nodes(yin):
        for ix, wx in nodes(xin):
            valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
            idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(-1)
            v = flat[:, idx].reshape(planes.shape)
            v = torch.where(valid, v, torch.zeros_like(v))
            term = v if wy is None else (wy * wx) * v
            out = term if out is None else out + term
    return out


def rotate_clip(clip, angle_deg, annotations=None):
    """The apply half of ``RandomRotation``: every frame of [F, H, W, C]
    rotated by one angle (degrees, f32), bilinear; annotations [F, h, w]
    nearest. Returns clip or (clip, annotations)."""
    angle = float(torch.tensor(angle_deg, dtype=torch.float32)
                  * torch.tensor(math.pi / 180.0, dtype=torch.float32))
    frames = _rotate_planes(clip.float().movedim(-1, 1), angle, 1).movedim(1, -1)
    if annotations is None:
        return frames
    ann = _rotate_planes(annotations.float(), angle, 0).to(annotations.dtype)
    return frames, ann


def random_rotation(clip, degrees, generator=None, annotations=None):
    """The reference ``RandomRotation``: one angle drawn uniformly from
    ``degrees`` (a scalar d means (-d, d)) for the whole clip."""
    if isinstance(degrees, (int, float)):
        degrees = (-float(degrees), float(degrees))
    angle = torch.rand((), generator=generator) * (degrees[1] - degrees[0]) + degrees[0]
    return rotate_clip(clip, float(angle), annotations)


# ------------------------------------------------------------------ #
# the deterministic eval path

def eval_preprocess_batch(frames, out_size: int = 224,
                          std: tuple = REFERENCE_STD, compute_dtype=None):
    """[..., H, W, 3] frames -> [..., S, S, 3] normalised, in
    ``compute_dtype`` (default f32). uint8 frames shrunk to bf16 run the
    preprocess kernel (ops/preprocess_cuda; its plain version for CPU
    tensors); everything else the f32 resize of ``jax.image.resize``
    bilinear, rounded once to ``compute_dtype``."""
    from timetuning_tpu_torch.ops.preprocess_cuda import (
        eval_preprocess_cuda,
        preprocess_cuda_available,
    )
    from timetuning_tpu_torch.ops.resize import resize_bilinear

    dt = torch.float32 if compute_dtype is None else compute_dtype
    h, w = frames.shape[-3:-1]
    if preprocess_cuda_available(h, w, out_size, frames.dtype, dt):
        return eval_preprocess_cuda(frames, out_size, IMAGENET_MEAN, std,
                                    out_dtype=dt)
    x = frames.float() / 255.0
    x = resize_bilinear(x.movedim(-1, -3), (out_size, out_size)).movedim(-3, -1)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    return ((x - mean) / torch.tensor(std, dtype=torch.float32,
                                      device=x.device)).to(dt)


def eval_preprocess_flat(frames_flat, src_hw: tuple, out_size: int = 224,
                         std: tuple = REFERENCE_STD, compute_dtype=None):
    """``eval_preprocess_batch`` over channel-interleaved flat frames
    ``[..., H, W*3]`` (a free view of ``[..., H, W, 3]``)."""
    h, w = src_hw
    if frames_flat.shape[-2:] != (h, w * 3):
        raise ValueError(
            f"eval_preprocess_flat: frames of shape {tuple(frames_flat.shape)} "
            f"do not hold [..., {h}, {w}*3] for src_hw={src_hw}")
    frames = frames_flat.reshape(frames_flat.shape[:-2] + (h, w, 3))
    return eval_preprocess_batch(frames, out_size=out_size, std=std,
                                 compute_dtype=compute_dtype)
