"""The benchmark's one traffic generator: seeded synthetic video.

A traffic file (``benchmark/traffic/<name>.json``) gives the sizes; this
module makes the frames from ``--seed``, on the device in a few large calls,
and hands them to the host as uint8, as a decoder would. A clip is
``objects`` boxes moving at constant velocity over a background (a colour
gradient, or noise), each box one colour or a fixed random texture; the
object-id map of every frame comes with it. The same seed gives the same
frames; another seed other frames of the same sizes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def device_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def _uniform(gen, lo, hi, *shape, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def clips(seed: int, n: int, frames: int, height: int, width: int, objects: tuple,
          textured: bool, background: str, device, chunk: int = 4):
    """(frames [n, T, H, W, 3] uint8, ids [n, T, H, W] uint8) on the host.
    ``objects``: (least, most) boxes a clip; ``background``: "gradient" or
    "noise"."""
    gen = device_generator(seed, device)
    out_f = np.empty((n, frames, height, width, 3), np.uint8)
    out_a = np.empty((n, frames, height, width), np.uint8)
    yy = torch.linspace(0.0, 1.0, height, device=device)[:, None]
    xx = torch.linspace(0.0, 1.0, width, device=device)[None, :]
    t = torch.arange(frames, dtype=torch.float32, device=device)
    for c0 in range(0, n, chunk):
        m = min(chunk, n - c0)
        if background == "gradient":
            a = _uniform(gen, 30, 220, m, 1, 1, 1, 3, device=device)
            b = _uniform(gen, 30, 220, m, 1, 1, 1, 3, device=device)
            img = (a * yy[None, None, :, :, None] + b * xx[None, None, :, :, None]
                   ).expand(m, frames, height, width, 3).clone()
        else:
            img = _uniform(gen, 0, 60, m, frames, height, width, 3, device=device)
        ids = torch.zeros(m, frames, height, width, dtype=torch.uint8, device=device)
        count = torch.randint(objects[0], objects[1] + 1, (m,), generator=gen, device=device)
        for k in range(objects[1]):
            pos = _uniform(gen, 0.2, 0.8, m, 2, device=device)
            vel = _uniform(gen, -0.012, 0.012, m, 2, device=device)
            half = _uniform(gen, 0.06, 0.18, m, 2, device=device)
            cy = (pos[:, 0, None] + vel[:, 0, None] * t)[:, :, None, None]
            cx = (pos[:, 1, None] + vel[:, 1, None] * t)[:, :, None, None]
            inside = (((yy - cy).abs() < half[:, 0, None, None, None])
                      & ((xx - cx).abs() < half[:, 1, None, None, None])
                      & (k < count)[:, None, None, None])
            if textured:
                tex = _uniform(gen, 100, 256, m, 3, 24, 40, device=device)
                tex = F.interpolate(tex, size=(height, width), mode="nearest")
                color = tex.permute(0, 2, 3, 1)[:, None]
            else:
                color = _uniform(gen, 0, 256, m, 1, 1, 1, 3, device=device)
            img = torch.where(inside[..., None], color, img)
            ids = torch.where(inside, torch.full_like(ids, k + 1), ids)
        out_f[c0:c0 + m] = img.clamp(0, 255).to(torch.uint8).cpu().numpy()
        out_a[c0:c0 + m] = ids.cpu().numpy()
    return out_f, out_a


def pil_gray_means(frames: np.ndarray) -> np.ndarray:
    """[..., H, W, 3] uint8 -> each frame's PIL gray mean [...] (the
    integer luma ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``, averaged),
    as a decoder reports it with the frame."""
    u = torch.from_numpy(frames).to(torch.int64)
    lum = (19595 * u[..., 0] + 38470 * u[..., 1] + 7471 * u[..., 2] + 32768) >> 16
    return lum.double().mean(dim=(-2, -1)).float().numpy()


def order(seed: int, n: int, length: int) -> np.ndarray:
    """A seeded sequence of ``length`` bank indices: the bank's clips
    cycled, each cycle in its own seeded order (every seed the same sizes,
    in another order)."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), 0x7EAF])
    cycles = -(-length // n)
    return np.concatenate([rng.permutation(n) for _ in range(cycles)])[:length]
