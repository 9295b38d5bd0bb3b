# The port's own copy of timetuning_tpu/eval/optical_flow.py (host code, no JAX);
# tests/test_torch_host_copies.py pins it to the original.
"""Farnebäck optical-flow mask-propagation baseline (host-side OpenCV).

Reference: mask_propagation.py:265-346 — dense Farnebäck flow between
consecutive frames, warping the running mask with ``cv2.remap``. This is a
comparison baseline, not a TPU path; it stays on the host exactly as the
reference's does (SURVEY.md §2.3 marks it optional-host).
"""

from __future__ import annotations

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


def dense_optical_flow(frames: np.ndarray) -> np.ndarray:
    """[T, H, W, 3] uint8 → [T-1, H, W, 2] backward Farnebäck flow fields
    (frame t → frame t-1), the direction needed for backward warping."""
    assert cv2 is not None
    grays = [cv2.cvtColor(f, cv2.COLOR_RGB2GRAY) for f in frames]
    flows = []
    for prev, cur in zip(grays[:-1], grays[1:]):
        flows.append(
            cv2.calcOpticalFlowFarneback(
                cur, prev, None, pyr_scale=0.5, levels=3, winsize=15,
                iterations=3, poly_n=5, poly_sigma=1.2, flags=0,
            )
        )
    return np.stack(flows)


def warp_mask(mask: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Backward-warp a mask by one flow field (reference
    ``interpolate_frames``, mask_propagation.py:322-333)."""
    h, w = mask.shape[:2]
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    map_x = (gx + flow[..., 0]).astype(np.float32)
    map_y = (gy + flow[..., 1]).astype(np.float32)
    return cv2.remap(
        mask.astype(np.uint8), map_x, map_y, interpolation=cv2.INTER_NEAREST
    )


def propagate_flow(frames: np.ndarray, first_mask: np.ndarray) -> np.ndarray:
    """Propagate the first-frame mask through the clip via flow warping
    (reference ``propagate``, mask_propagation.py:336-346). Returns
    [T-1, H, W] masks for frames 1..T-1."""
    flows = dense_optical_flow(frames)
    out = []
    mask = first_mask
    for fl in flows:
        mask = warp_mask(mask, fl)
        out.append(mask)
    return np.stack(out)
