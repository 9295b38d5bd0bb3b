"""Batched image and feature resizing by interpolation matrices.

Counterpart of ``timetuning_tpu/ops/resize.py``. Every resize here is a pair
of small matrices applied along the two spatial axes, built in numpy so the
values equal the JAX package's: ``jax.image.resize`` bilinear (antialiased
when shrinking), torch's bicubic (A=-0.75) for positional embeddings, and
``jax.image.resize`` nearest (half-pixel centres) for annotations.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from timetuning_tpu_torch.ops.preprocess_cuda import _resize_weights
from timetuning_tpu_torch.ops.util import device_constant


@functools.lru_cache(maxsize=64)
def _bilinear_matrix(n_in: int, n_out: int):
    """[n_out, n_in] weights of jax.image.resize's bilinear kernel for
    upsampling (half-pixel centres, edge rows renormalised). Copied from
    timetuning_tpu/ops/resize.py:12-27 (that module imports jax)."""
    i = np.arange(n_out)
    src = (i + 0.5) * n_in / n_out - 0.5
    lo = np.floor(src).astype(int)
    w_hi = (src - lo).astype(np.float32)
    W = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        lo_c = min(max(lo[o], 0), n_in - 1)
        hi_c = min(max(lo[o] + 1, 0), n_in - 1)
        W[o, lo_c] += 1.0 - w_hi[o]
        W[o, hi_c] += w_hi[o]
    return W


@functools.lru_cache(maxsize=64)
def _cubic_matrix(n_in: int, n_out: int, inv_scale: float | None = None):
    """[n_out, n_in] weights of torch's ``F.interpolate(mode='bicubic',
    align_corners=False)``: cubic convolution with A=-0.75, half-pixel
    centres, out-of-range taps clamped to the border. ``inv_scale`` overrides
    the source step (torch uses the caller's scale factor; DINO passes a
    ``(n_out + 0.1) / n_in`` fudge). Copied from
    timetuning_tpu/ops/resize.py:30-67 (that module imports jax)."""
    A = -0.75

    def k(s):
        s = abs(s)
        if s <= 1.0:
            return (A + 2.0) * s**3 - (A + 3.0) * s**2 + 1.0
        if s < 2.0:
            return A * (s**3 - 5.0 * s**2 + 8.0 * s - 4.0)
        return 0.0

    W = np.zeros((n_out, n_in), np.float64)
    scale = n_in / n_out if inv_scale is None else inv_scale
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        b = int(np.floor(src))
        t = src - b
        for tap, w in zip(
            (b - 1, b, b + 1, b + 2),
            (k(1.0 + t), k(t), k(1.0 - t), k(2.0 - t)),
        ):
            W[i, min(max(tap, 0), n_in - 1)] += w
    return W.astype(np.float32)


@device_constant
def _mat(build, args: tuple, device: torch.device) -> torch.Tensor:
    """``build(*args)`` on ``device``, made once per (matrix, device). Made
    from Python numbers on the device itself: while ``torch.export`` traces,
    it is then a device constant of the program (from a numpy array it would
    be a host constant, copied to the device on every call)."""
    m = build(*args)
    return torch.tensor(m.tolist(), dtype=torch.from_numpy(m).dtype, device=device)


def resize_bicubic_torch(x, size: tuple[int, int],
                         scales: tuple[float, float] | None = None):
    """[..., H, W, C] -> [..., h, w, C] as torch bicubic (align_corners=False,
    no antialias); ``scales`` are explicit forward scale factors for the
    coordinate mapping."""
    H, W = x.shape[-3:-1]
    oh, ow = size
    inv_h = None if scales is None else 1.0 / scales[0]
    inv_w = None if scales is None else 1.0 / scales[1]
    Wh = _mat(_cubic_matrix, (H, oh, inv_h), x.device)
    Ww = _mat(_cubic_matrix, (W, ow, inv_w), x.device)
    out = torch.einsum("...hwc,Hh,Ww->...HWc", x.float(), Wh, Ww)
    return out.to(x.dtype)


def _axis_matrix(n_in: int, n_out: int, upscale: bool) -> np.ndarray:
    return _bilinear_matrix(n_in, n_out) if upscale else _resize_weights(n_in, n_out)


def resize_bilinear(x, size: tuple[int, int]):
    """Bilinear resize of a float [..., H, W] to [..., h, w] with the values
    of the JAX package's ``resize_bilinear``: the 2-tap matrices when both
    axes grow, jax.image.resize's antialiased kernel otherwise."""
    H, W = x.shape[-2:]
    oh, ow = size
    up = oh >= H and ow >= W
    Wh = _mat(_axis_matrix, (H, oh, up), x.device)
    Ww = _mat(_axis_matrix, (W, ow, up), x.device)
    out = torch.einsum("...hw,Hh,Ww->...HW", x.float(), Wh, Ww)
    return out.to(x.dtype)


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """jax.image.resize 'nearest': source index floor((i + 0.5) * n_in / n_out)
    in f32 (half-pixel centres; torch's mode='nearest' uses floor(i * scale)
    instead)."""
    f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
         * np.float32(n_in)) / np.float32(n_out)
    return np.minimum(np.floor(f).astype(np.int64), n_in - 1)


def resize_nearest(x, size: tuple[int, int]):
    """Nearest-neighbour resize of [..., H, W] (annotation co-transform)."""
    H, W = x.shape[-2:]
    ih = _mat(_nearest_index, (H, size[0]), x.device)
    iw = _mat(_nearest_index, (W, size[1]), x.device)
    return x.index_select(-2, ih).index_select(-1, iw)


def patch_grid_to_image(feats, grid: tuple[int, int], size: tuple[int, int]):
    """[..., N, D] patch features -> [..., h, w, D] bilinearly upsampled maps
    (``timetuning_tpu/ops/resize.patch_grid_to_image``): two interpolation
    products in f32 when both axes grow, the antialiased resize otherwise."""
    *lead, N, D = feats.shape
    gh, gw = grid
    if gh * gw != N:
        raise ValueError(f"patch_grid_to_image: grid {grid} does not hold {N} patches")
    x = feats.reshape(*lead, gh, gw, D)
    oh, ow = size
    if oh < gh or ow < gw:
        return resize_bilinear(x.movedim(-1, -3), size).movedim(-3, -1)
    Wh = _mat(_bilinear_matrix, (gh, oh), x.device)
    Ww = _mat(_bilinear_matrix, (gw, ow), x.device)
    out = torch.einsum("...hwc,Hh,Ww->...HWc", x.float(), Wh, Ww)
    return out.to(feats.dtype)
