# The port's own copy of timetuning_tpu/obs/viz.py (host code, no JAX), with its
# imports of the package renamed; tests/test_torch_host_copies.py pins it to the original.
"""Visualization artifacts: DAVIS-palette PNGs, gifs, cluster overlays.

Reference: my_utils.py:41-158 (``localize_objects`` overlays,
``imwrite_indexed`` DAVIS palette, ``convert_list_to_video`` gifs,
``make_seg_maps``, ``denormalize``).
"""

from __future__ import annotations

import functools
import os

import numpy as np

# DAVIS 2017 palette head (index → RGB); remaining entries generated.
_DAVIS_BASE = [
    (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0), (0, 0, 128),
    (128, 0, 128), (0, 128, 128), (128, 128, 128), (64, 0, 0), (191, 0, 0),
    (64, 128, 0), (191, 128, 0), (64, 0, 128), (191, 0, 128), (64, 128, 128),
    (191, 128, 128),
]


@functools.lru_cache(maxsize=1)
def _davis_palette_cached() -> np.ndarray:
    pal = np.zeros((256, 3), np.uint8)
    for i, c in enumerate(_DAVIS_BASE):
        pal[i] = c
    rng = np.random.default_rng(1)
    pal[len(_DAVIS_BASE):] = rng.integers(
        0, 256, size=(256 - len(_DAVIS_BASE), 3)
    )
    pal.setflags(write=False)
    return pal


def davis_palette() -> np.ndarray:
    """The 256-color DAVIS palette — constant, computed once (per-frame
    gif loops call this via colorize_segmentation)."""
    return _davis_palette_cached()


def generate_colors(n: int) -> np.ndarray:
    """n distinct RGB colors (reference my_utils.py:82-89)."""
    return davis_palette()[1 : n + 1]


def denormalize(img: np.ndarray, mean, std) -> np.ndarray:
    """Undo normalization for display (reference my_utils.py:68-70).
    img: [..., 3] float."""
    return np.clip(np.asarray(img) * np.asarray(std) + np.asarray(mean), 0, 1)


def imwrite_indexed(path: str, seg: np.ndarray) -> None:
    """Palette-indexed PNG in the DAVIS style (reference my_utils.py:72-79)."""
    from PIL import Image

    im = Image.fromarray(seg.astype(np.uint8), mode="P")
    im.putpalette(davis_palette().reshape(-1).tolist())
    im.save(path)


def colorize_segmentation(seg: np.ndarray) -> np.ndarray:
    """[H, W] int → [H, W, 3] uint8 via the palette."""
    return davis_palette()[seg.astype(np.int64) % 256]


def overlay_segmentation(
    image: np.ndarray, seg: np.ndarray, alpha: float = 0.5
) -> np.ndarray:
    """Blend a cluster map over an image (reference ``localize_objects``,
    my_utils.py:41-65). image: [H, W, 3] float [0,1]; seg: [H, W] int."""
    color = colorize_segmentation(seg).astype(np.float32) / 255.0
    fg = seg > 0
    out = image.copy()
    out[fg] = (1 - alpha) * image[fg] + alpha * color[fg]
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def write_gif(frames: list[np.ndarray], path: str, fps: int = 10) -> str:
    """Frame list → gif (reference ``convert_list_to_video``,
    my_utils.py:139-143)."""
    import imageio

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imageio.mimsave(path, [np.asarray(f).astype(np.uint8) for f in frames],
                    duration=1.0 / fps)
    return path


def write_video(frames: list[np.ndarray], path: str, fps: int = 10) -> str:
    """Frame list → mp4 via OpenCV (reference ``visualize_sampled_videos``,
    my_utils.py:111-131)."""
    import cv2

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not vw.isOpened():
        raise RuntimeError(
            f"cv2.VideoWriter could not open {path} (mp4v codec missing?) "
            "- would have written an empty artifact"
        )
    for f in frames:
        vw.write(cv2.cvtColor(np.asarray(f).astype(np.uint8), cv2.COLOR_RGB2BGR))
    vw.release()
    return path


def clip_overlay_frames(
    images: np.ndarray, segs: np.ndarray, mean, std
) -> list[np.ndarray]:
    """[F, H, W, 3] normalized frames + [F, h, w] cluster maps → overlay
    frames for gif logging (reference evaluation.py:270-300)."""
    import cv2

    out = []
    for img, seg in zip(images, segs):
        img_d = denormalize(img, mean, std)
        # int32, NOT uint8: overclustering ids >= 256 must not wrap (the
        # palette indexing takes % 256 later, which only affects colors)
        seg_r = cv2.resize(
            seg.astype(np.int32), img_d.shape[:2][::-1],
            interpolation=cv2.INTER_NEAREST,
        )
        out.append(overlay_segmentation(img_d, seg_r))
    return out
