"""The plain reference of TimeT's training augmentation.

A frozen copy of the port's plain torch augmentation
(``timetuning_tpu_torch/data/transforms.py``: the draws of a batch and
their application), kept here so that the yardstick does not move when the
program does. It follows the reference chain (time_tuning.py:587-593:
ColorJitter(0.8, 0.8, 0.8, 0.2) at p 0.8 -> RandomGrayscale 0.2 -> Gaussian
blur p 0.5 -> Resize -> RandomResizedCrop(0.4-1, 3/4-4/3) -> horizontal
flip p 0.5 -> normalise with mean (0.485, 0.456, 0.406), std (0.228, 0.224,
0.225)): one jitter op a clip, the gray mean of the native frame for the
contrast, the blur and the crop as one matrix a frame and an axis.

Imports nothing of the program, of JAX, or of the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.228, 0.224, 0.225)
CROP_SCALE = (0.4, 1.0)
CROP_RATIO = (3.0 / 4.0, 4.0 / 3.0)
HFLIP_P, JITTER_P, GRAYSCALE_P, BLUR_P = 0.5, 0.8, 0.2, 0.5
BRIGHTNESS = CONTRAST = SATURATION = 0.8
HUE = 0.2
BLUR_SIGMA = (0.1, 2.0)
BLUR_KSIZE = 23
_TRIES = 10
_COLUMNS = ("brightness", "contrast", "saturation", "hue", "op", "jitter",
            "gray", "blur", "flip", "crop_i", "crop_j")

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
    # (a host scalar: a multiplier rounded to f32, no copy to the device)
    n = float(np.float32(1.0 / (lum.shape[-1] * lum.shape[-2])))
    return lum.sum(dim=(-2, -1)) * n


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



# --------------------------------------------------------------------- #
# the drawn values of a batch: one table [B, 11 + F + 20]

def draw(generator: torch.Generator, B: int, F: int) -> torch.Tensor:
    """Every random value of one batch's augmentation, in the program's draw
    order: per clip the four jitter factors, the op, the jitter / gray /
    blur decisions, a blur sigma a frame, the crop's ten scale and ten
    log-ratio tries and its position, the flip."""

    def uniform(lo, hi, *shape):
        return torch.rand(shape, generator=generator) * (hi - lo) + lo

    def factor(strength):
        return uniform(max(0.0, 1.0 - strength), 1.0 + strength, B)

    brightness = factor(BRIGHTNESS)
    contrast = factor(CONTRAST)
    saturation = factor(SATURATION)
    hue = uniform(-HUE, HUE, B)
    op = torch.randint(0, 4, (B,), generator=generator)
    jitter = torch.rand(B, generator=generator) < JITTER_P
    gray = torch.rand(B, generator=generator) < GRAYSCALE_P
    sigma = uniform(BLUR_SIGMA[0], BLUR_SIGMA[1], B, F)
    blur = torch.rand(B, generator=generator) < BLUR_P
    crop_scale = uniform(CROP_SCALE[0], CROP_SCALE[1], B, _TRIES)
    crop_log_ratio = uniform(math.log(CROP_RATIO[0]), math.log(CROP_RATIO[1]), B, _TRIES)
    crop_i = torch.rand(B, generator=generator)
    crop_j = torch.rand(B, generator=generator)
    flip = torch.rand(B, generator=generator) < HFLIP_P
    cols = [torch.as_tensor(v, dtype=torch.float32).reshape(-1, 1)
            for v in (brightness, contrast, saturation, hue, op, jitter, gray, blur,
                      flip, crop_i, crop_j)]
    return torch.cat(cols + [sigma.float(), crop_scale.float(), crop_log_ratio.float()], dim=1)


def _col(table, name):
    return table[:, _COLUMNS.index(name)]


# --------------------------------------------------------------------- #
# geometry

def resize_geometry(h0, w0, size: int):
    """The reference's short-side Resize (video_transformations.py:96-103,
    with its int() truncation)."""
    size = float(size)
    rh = torch.where(w0 < h0, torch.floor(size * h0 / w0), torch.full_like(h0, size))
    rw = torch.where(w0 < h0, torch.full_like(w0, size), torch.floor(size * w0 / h0))
    return rh, rw


def _sample_rrc_box(scale, log_ratio, iu, ju, h, w):
    """torchvision RandomResizedCrop.get_params on drawn tries: the first of
    the ten that fits, else the ratio-clamped centre crop."""
    area = h * w
    target_area = scale * area[:, None]
    ratio = torch.exp(log_ratio)
    cw = torch.sqrt(target_area * ratio)
    ch = torch.sqrt(target_area / ratio)
    valid = (cw <= w[:, None]) & (ch <= h[:, None]) & (cw > 0) & (ch > 0)
    pick = valid.to(torch.uint8).argmax(dim=1, keepdim=True)
    any_valid = valid.any(dim=1)
    cw_s = cw.gather(1, pick)[:, 0]
    ch_s = ch.gather(1, pick)[:, 0]
    i = iu * (h - ch_s)
    j = ju * (w - cw_s)
    r0, r1 = CROP_RATIO
    in_ratio = w / h
    fw = torch.where(in_ratio < r0, w, torch.where(in_ratio > r1, h * r1, w))
    fh = torch.where(in_ratio < r0, w / r0, h)
    fi, fj = (h - fh) / 2.0, (w - fw) / 2.0
    return (torch.where(any_valid, i, fi), torch.where(any_valid, j, fj),
            torch.where(any_valid, ch_s, fh), torch.where(any_valid, cw_s, fw))


def scale_translate_weights(n_in: int, n_out: int, scale, translation):
    """[B, n_out, n_in] bilinear weights of ``scale_and_translate`` along
    one axis: output pixel p samples input ``(p + 0.5 - t) / scale - 0.5``,
    the triangle widened by 1 / scale when shrinking, each output's taps
    normalised, zero where the sample lies outside the input."""
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5)
                * inv_scale[:, None] - (translation * inv_scale)[:, None] - 0.5)
    x = torch.abs(sample_f[:, None, :]
                  - torch.arange(n_in, dtype=torch.float32, device=dev)[None, :, None]
                  ) / kernel_scale[:, None, None]
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = torch.where(inside[:, None, :], w, torch.zeros_like(w))
    return w.transpose(1, 2)


def _reflect_taps(n: int, ksize: int, device) -> torch.Tensor:
    pos = np.arange(n)[:, None] + np.arange(ksize)[None, :] - ksize // 2
    if n == 1:
        return torch.zeros(pos.shape, dtype=torch.int64, device=device)
    period = 2 * (n - 1)
    m = np.abs(pos) % period
    return torch.from_numpy(np.where(m >= n, period - m, m)).to(device)


def _blur_matrices(n: int, sigma, do_blur, ksize: int):
    """[B, F, n, n] Gaussian blur along one axis with reflect padding, the
    identity where a clip does not blur."""
    B, F = sigma.shape
    dev = sigma.device
    r = torch.arange(ksize, dtype=torch.float32, device=dev) - (ksize - 1) / 2
    k = torch.exp(-(r ** 2) / (2.0 * sigma[..., None] ** 2))
    k = k / k.sum(dim=-1, keepdim=True)
    delta = (torch.arange(ksize, device=dev) == ksize // 2).float()
    k = torch.where(do_blur[:, None, None], k, delta)
    idx = _reflect_taps(n, ksize, dev)
    out = torch.zeros(B, F, n, n, dtype=torch.float32, device=dev)
    return out.scatter_add_(-1, idx.expand(B, F, n, ksize),
                            k[:, :, None, :].expand(B, F, n, ksize))


def _resample(x, my, mx):
    B, F, H, W, C = x.shape
    oh, ow = my.shape[-2], mx.shape[-2]
    t = torch.matmul(my, x.reshape(B, F, H, W * C)).reshape(B, F, oh, W, C)
    t = t.transpose(2, 3).reshape(B, F, W, oh * C)
    out = torch.matmul(mx, t).reshape(B, F, ow, oh, C)
    return out.transpose(2, 3)


# --------------------------------------------------------------------- #

def augment(frames, table, src_sizes, gray_means, out_size: int = 224):
    """frames [B, F, H, W, 3] uint8, ``table`` from ``draw``, ``src_sizes``
    [B, 2] the native (H0, W0), ``gray_means`` [B, F] the native frames' PIL
    gray means -> normalised f32 [B, F, out_size, out_size, 3]."""
    B, F, H, W, _ = frames.shape
    dev = frames.device
    p = table.to(dev)
    x = frames.float() / 255.0
    sizes = torch.as_tensor(src_sizes).to(dev, torch.float32)
    h0, w0 = sizes[:, 0], sizes[:, 1]
    blur_y, blur_x = H / h0, W / w0
    geo_h, geo_w = resize_geometry(h0, w0, out_size)
    box_y, box_x = H / geo_h, W / geo_w

    jit, op = _col(p, "jitter") > 0, _col(p, "op")
    is_b, is_c, is_s = jit & (op == 0), jit & (op == 1), jit & (op == 2)
    is_h = jit & (op == 3)
    fc, fs = _col(p, "contrast"), _col(p, "saturation")
    one = torch.ones_like(fc)
    a = torch.where(is_b, _col(p, "brightness"),
                    torch.where(is_c, fc, torch.where(is_s, fs, one)))
    c = torch.where(is_s, 1.0 - fs, torch.zeros_like(fs))
    mean255 = torch.as_tensor(gray_means).to(dev, torch.float32)
    mean255 = torch.where(torch.isnan(mean255), _pil_gray_mean(x), mean255)
    d = torch.where(is_c[:, None], _contrast_offset(mean255, fc[:, None]),
                    torch.zeros_like(mean255))
    y = _blend(x, a.view(B, 1, 1, 1, 1), _grayscale(x) * c.view(B, 1, 1, 1, 1),
               d.view(B, F, 1, 1, 1))
    y = torch.where(is_h.view(B, 1, 1, 1, 1),
                    _adj_hue(x, _col(p, "hue").view(B, 1, 1, 1)), y)
    x = torch.where(_col(p, "gray").view(B, 1, 1, 1, 1) > 0,
                    _grayscale(y).expand_as(y), y)

    n = len(_COLUMNS)
    sigma = p[:, n:n + F]
    scale, log_ratio = p[:, n + F:n + F + _TRIES], p[:, n + F + _TRIES:n + F + 2 * _TRIES]
    i, j, ch, cw = _sample_rrc_box(scale, log_ratio, _col(p, "crop_i"),
                                   _col(p, "crop_j"), geo_h, geo_w)
    i, j, ch, cw = i * box_y, j * box_x, ch * box_y, cw * box_x
    flip = _col(p, "flip") > 0
    do_blur = _col(p, "blur") > 0
    wy = scale_translate_weights(H, out_size, out_size / ch, -i * (out_size / ch))
    wx = scale_translate_weights(W, out_size, out_size / cw, -j * (out_size / cw))
    wx = torch.where(flip[:, None, None], wx.flip(1), wx)
    wy = torch.matmul(wy[:, None], _blur_matrices(H, sigma * blur_y[:, None], do_blur,
                                                  BLUR_KSIZE))
    wx = torch.matmul(wx[:, None], _blur_matrices(W, sigma * blur_x[:, None], do_blur,
                                                  BLUR_KSIZE))
    x = _resample(x, wy, wx)
    mean = torch.tensor(MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(STD, dtype=torch.float32, device=dev)
    return (torch.clamp(x, 0.0, 1.0) - mean) / std
