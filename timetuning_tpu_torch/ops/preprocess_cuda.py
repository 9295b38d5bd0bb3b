"""The eval-preprocess kernel (csrc/preprocess.cu) and its plain version.

uint8 frames ``[..., H, W, 3]`` -> antialiased bilinear resize to S x S,
/255 and ``(x - mean) / std``, in ``out_dtype``. Counterpart of
``timetuning_tpu/ops/preprocess_pallas.py``. The resize weights are the
exact matrices of ``jax.image.resize(..., 'bilinear')``, built in numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from timetuning_tpu_torch.ops import kernel_lib


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of ``jax.image.resize(x, (n_out, ...),
    'bilinear')``: half-pixel-centred triangle kernel, widened by 1/scale when
    downscaling (antialias), rows renormalised so out-of-range taps
    redistribute to the edge. Copied from
    timetuning_tpu/ops/preprocess_pallas.py:66-81 (that module imports jax)."""
    scale = n_out / n_in
    sample_f = (np.arange(n_out) + 0.5) / scale - 0.5        # src centers
    inv = max(1.0 / scale, 1.0)                              # antialias width
    j = np.arange(n_in)
    t = (j[None, :] - sample_f[:, None]) / inv
    w = np.maximum(0.0, 1.0 - np.abs(t))                     # triangle
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w.astype(np.float32)


def _band(wm: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A banded [n_out, n_in] matrix as (start [n_out] int32, taps
    [n_out, n_taps] f32) with ``wm[o, start[o] + k] == taps[o, k]``."""
    n_out, n_in = wm.shape
    nz = wm != 0
    lo = nz.argmax(axis=1)
    hi = n_in - 1 - nz[:, ::-1].argmax(axis=1)
    n_taps = int((hi - lo).max()) + 1
    start = np.minimum(lo, n_in - n_taps).astype(np.int32)
    idx = start[:, None] + np.arange(n_taps)[None, :]
    return start, np.take_along_axis(wm, idx, axis=1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _band_tensors(n_in: int, n_out: int, device: str):
    start, taps = _band(_resize_weights(n_in, n_out))
    return (torch.from_numpy(start).to(device), torch.from_numpy(taps).to(device),
            taps.shape[1])


def preprocess_cuda_available(h: int, w: int, out_size: int, frames_dtype,
                              compute_dtype) -> bool:
    """The kernel's gate, as the TPU kernel's (preprocess_pallas.py:130-153):
    uint8 input, bf16 output, downscale on both axes."""
    s = out_size
    return (frames_dtype == torch.uint8 and compute_dtype == torch.bfloat16
            and h >= s and w >= s and h >= 2 and w >= 2)


def eval_preprocess_plain(frames, out_size: int, mean: tuple, std: tuple,
                          out_dtype=torch.bfloat16):
    """The plain version: f32 resize by the two weight matrices, then the
    normalisation, rounded once to ``out_dtype``."""
    h, w = frames.shape[-3:-1]
    wh = torch.from_numpy(_resize_weights(h, out_size)).to(frames.device)
    ww = torch.from_numpy(_resize_weights(w, out_size)).to(frames.device)
    x = frames.float() / 255.0
    x = torch.einsum("...hwc,Hh,Ww->...HWc", x, wh, ww)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=frames.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=frames.device)
    return ((x - mean_t) / std_t).to(out_dtype)


def eval_preprocess_cuda(frames, out_size: int, mean: tuple, std: tuple,
                         out_dtype=torch.bfloat16):
    """Kernel 4. [..., H, W, 3] uint8 -> [..., S, S, 3] bf16; callers gate
    with ``preprocess_cuda_available``."""
    if frames.device.type == "cpu":
        return eval_preprocess_plain(frames, out_size, mean, std, out_dtype)
    lead = frames.shape[:-3]
    h, w, c = frames.shape[-3:]
    s = out_size
    if (c != 3 or out_dtype != torch.bfloat16
            or not preprocess_cuda_available(h, w, s, frames.dtype, out_dtype)):
        raise ValueError(
            f"eval_preprocess_cuda: takes uint8 [..., H, W, 3] downscaled to "
            f"bf16, got {frames.dtype} {tuple(frames.shape)} -> {s} {out_dtype}")
    n = int(np.prod(lead)) if lead else 1
    x = frames.contiguous()
    dev = str(x.device)
    hs, hw, h_taps = _band_tensors(h, s, dev)
    ws, www, w_taps = _band_tensors(w, s, dev)
    kernel_lib.require_cuda("eval_preprocess_cuda", x, hs, ws)
    out = torch.empty(lead + (s, s, 3), dtype=torch.bfloat16, device=x.device)
    kernel_lib.launch(
        "preprocess", "tt_eval_preprocess", x.device,
        x.data_ptr(), hs.data_ptr(), hw.data_ptr(), h_taps, ws.data_ptr(),
        www.data_ptr(), w_taps, *(float(m) for m in mean),
        *(1.0 / float(v) for v in std), out.data_ptr(), n, h, w, s)
    return out
