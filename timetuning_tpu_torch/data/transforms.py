"""Deterministic eval preprocessing: resize + normalise.

Counterpart of ``eval_preprocess_batch`` / ``eval_preprocess_flat`` in
``timetuning_tpu/data/transforms.py`` (the reference eval pipeline: Resize ->
ClipToTensor -> Normalize). The training augmentations of that module are
still to port (ROADMAP queue 1).
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
# The reference's (typo'd) ImageNet std, kept for checkpoint parity
# (time_tuning.py:592).
REFERENCE_STD = (0.228, 0.224, 0.225)
IMAGENET_STD = (0.229, 0.224, 0.225)


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
