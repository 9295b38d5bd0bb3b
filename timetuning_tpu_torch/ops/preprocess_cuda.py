"""The eval-preprocess kernel (csrc/preprocess.cu) and its plain version.

uint8 frames ``[..., H, W, 3]`` -> antialiased bilinear resize to S x S,
/255 and ``(x - mean) / std``, in ``out_dtype``. Counterpart of
``timetuning_tpu/ops/preprocess_pallas.py``. The resize weights are the
exact matrices of ``jax.image.resize(..., 'bilinear')``, built in numpy.
``band_plan`` cuts the output rows into the kernel's bands and sizes its
shared memory; the kernel checks the plan against its own layout.
"""

from __future__ import annotations

import dataclasses
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


_STAGES = 4                 # csrc/preprocess.cu kStages
_MAX_SMEM = 232448          # bytes of shared memory a block may use
_SM_SMEM = 233472           # bytes an SM has for its blocks
_BLOCK_RESERVED = 1024      # bytes the card sets aside per resident block
_MAX_BLOCKS_PER_SM = 4      # the kernel's launch bounds


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """How ``csrc/preprocess.cu`` cuts one resize: ``bands`` bands of
    ``rows`` output rows a frame (the last may be shorter), each streaming
    its input rows ``chunk`` at a time through a ring of ``ring`` resampled
    rows; ``smem`` dynamic shared-memory bytes a block, ``blocks_per_sm``
    resident; ``in_rows`` the most input rows a band reads."""

    rows: int
    bands: int
    chunk: int
    ring: int
    smem: int
    blocks_per_sm: int
    h_taps: int
    w_taps: int
    in_rows: int

    def band_rows(self, s: int) -> list[tuple[int, int]]:
        """[y0, y1) of each band of an S-row output."""
        return [(y0, min(s, y0 + self.rows)) for y0 in range(0, s, self.rows)]


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _w_bucket(w_taps: int) -> int:
    """The W taps' stride in shared memory (the kernel's template bucket:
    4, 8, 16, else the taps themselves)."""
    for b in (4, 8, 16):
        if w_taps <= b:
            return b
    return w_taps


def smem_bytes(w: int, s: int, rows: int, chunk: int, ring: int, h_taps: int,
               w_taps: int) -> int:
    """The kernel's dynamic shared memory (``layout`` in csrc/preprocess.cu):
    the staging ring of bytes, the ring of resampled rows, the W starts and
    taps, the band's H starts, their ring slots and their taps."""
    b = _STAGES * _round_up(chunk * w * 3 + 15, 16)
    b += ring * _round_up(3 * s, 256) * 4
    b += _round_up(s * 4, 16) + _round_up(s * _w_bucket(w_taps) * 4, 16)
    return b + 2 * _round_up(rows * 4, 16) + _round_up(rows * h_taps * 4, 16)


@functools.lru_cache(maxsize=64)
def band_plan(h: int, w: int, s: int, frames: int = 1, sms: int = 132) -> BandPlan:
    """The kernel's plan for ``frames`` frames of [h, w] resized to s x s on
    a card of ``sms`` SMs.

    A chunk is about 6 KB of input rows. The ring keeps the chunk, the H
    taps of a row and the largest step between two rows' first taps: every
    output row not yet written, and the one whose last 16-byte group waits
    for the next chunk, still finds its input rows there. The bands: the
    count whose blocks cost least as ceil(blocks / SMs) x (input rows a band
    + 2), among the counts that give every SM at least two blocks where the
    frames allow it (a block's input rows are its time; fewer, longer bands
    read fewer halo rows). Raises if the smallest plan does not fit a
    block's shared memory."""
    h_start, h_w = _band(_resize_weights(h, s))
    _, w_w = _band(_resize_weights(w, s))
    h_taps, w_taps = h_w.shape[1], w_w.shape[1]
    chunk = int(min(16, max(1, round(6144 / (3 * w)))))
    step = int(np.diff(h_start).max()) if s > 1 else 0
    ring = chunk + h_taps - 1 + step
    best = None
    for bands in range(1, s + 1):
        rows = -(-s // bands)
        if -(-s // rows) != bands:
            continue
        smem = smem_bytes(w, s, rows, chunk, ring, h_taps, w_taps)
        if smem > _MAX_SMEM:
            continue
        y0 = np.arange(0, s, rows)
        y1 = np.minimum(y0 + rows, s)
        in_rows = int((h_start[y1 - 1] + h_taps - h_start[y0]).max())
        blocks = frames * bands
        cost = -(-blocks // sms) * (in_rows + 2)
        key = (blocks < min(2 * sms, frames * s), cost, bands)
        if best is None or key < best[0]:
            bps = min(_MAX_BLOCKS_PER_SM, _SM_SMEM // (smem + _BLOCK_RESERVED))
            best = (key, BandPlan(rows, bands, chunk, ring, smem, bps, h_taps,
                                  w_taps, in_rows))
    if best is None:
        raise ValueError(
            f"eval_preprocess_cuda: no band of [{h}, {w}] -> {s} fits "
            f"{_MAX_SMEM} bytes of shared memory (a ring of {ring} rows of "
            f"{3 * s} floats and {chunk}-row chunks of {3 * w} bytes)")
    return best[1]


@functools.lru_cache(maxsize=8)
def _sm_count(device: str) -> int:
    return torch.cuda.get_device_properties(torch.device(device)).multi_processor_count


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
    if x.data_ptr() % 16:           # the kernel reads 16-byte pieces
        x = x.clone()
    dev = str(x.device)
    hs, hw, h_taps = _band_tensors(h, s, dev)
    ws, www, w_taps = _band_tensors(w, s, dev)
    kernel_lib.require_cuda("eval_preprocess_cuda", x, hs, ws)
    plan = band_plan(h, w, s, n, _sm_count(dev))
    out = torch.empty(lead + (s, s, 3), dtype=torch.bfloat16, device=x.device)
    kernel_lib.launch(
        "preprocess", "tt_eval_preprocess", x.device,
        x.data_ptr(), hs.data_ptr(), hw.data_ptr(), h_taps, ws.data_ptr(),
        www.data_ptr(), w_taps, *(float(m) for m in mean),
        *(1.0 / float(v) for v in std), out.data_ptr(), n, h, w, s,
        plan.rows, plan.chunk, plan.ring, plan.smem)
    return out
