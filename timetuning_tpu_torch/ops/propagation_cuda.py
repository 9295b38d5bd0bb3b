"""The label-propagation kernel (csrc/propagation.cu) and its plain version.

Counterpart of ``timetuning_tpu/ops/propagation_pallas.py``. The TPU kernel
is gated to clips of at most 8 frames there, only because its Mosaic compile
time grows with T; this kernel has no such gate and serves the 25-frame eval
clips too, at any patch count.

The kernel works in two phases (csrc/propagation.cu): (a) the affinity rows
of every target frame, each kept as its top-k entries alone ("compact
rows": at most ``ROOM`` (key, weight) pairs and a count, or a flag for the
exact dense pass when the kept set does not fit), over 8 x 8 tiles of query
patches whose key boxes ``tile_plan`` gives; (b) the seg step over those
rows, one frame after the other, with the flagged rows through the exact
dense pass (``dense_plan``). ``compact_rows_plain`` and
``seg_from_compact_plain`` mirror the two phases in plain PyTorch;
``propagate_labels_batch_stats`` also returns how many rows took the dense
pass.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from timetuning_tpu_torch.ops import kernel_lib
from timetuning_tpu_torch.ops.propagation import (
    _EPS,
    _grid,
    context_slots,
    kth_largest_value,
    neighborhood_mask,
    propagate_labels,
)

TILE = 8           # query tiles are TILE x TILE patches
KEYS = 128         # keys a chunk of a tile's box (the products' N)
LIST = 8           # values a kernel lane keeps for each of its rows: k <= LIST
ROOM = 16          # kept entries a compact row holds
DENSE_BLOCKS = 264  # blocks a seg launch gives the dense pass, at most


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The kernel's tiling of an h x w patch grid (csrc/propagation.cu
    ``make_plan``): tiles_y x tiles_x query tiles; each scores, in every live
    context frame, a box of box_h x box_w keys that holds its queries'
    windows, in ``chunks`` chunks of ``chunk_rows`` box rows."""

    tiles_y: int
    tiles_x: int
    box_h: int
    box_w: int
    chunk_rows: int
    chunks: int


def tile_plan(h: int, w: int, radius: int) -> TilePlan:
    """Python mirror of the kernel's plan; the wrapper hands box_h, box_w and
    chunk_rows to C, which checks them against its own."""
    side = TILE + 2 * radius
    box_w = side if radius > 0 and side < w else w
    box_h = side if radius > 0 and side < h else h
    chunk_rows = min(box_h, KEYS // box_w) if box_w <= KEYS else 0
    chunks = -(-box_h // chunk_rows) if chunk_rows else 0
    return TilePlan(-(-h // TILE), -(-w // TILE), box_h, box_w, chunk_rows, chunks)


def dense_plan(B: int, T: int, h: int, w: int, D: int, radius: int,
               n_slots: int) -> tuple[int, int, bool]:
    """(blocks, row length, whether a row fits shared memory) of the exact
    dense pass (csrc/propagation.cu ``make_dense_plan``): a row holds each
    live context frame's window, or its whole frame where the window covers
    it or there is no neighbourhood; a row that does not fit a block's
    shared memory beside its key tile (256 keys x 33 floats, their keys,
    the query and 24 reduction slots) goes to the block's own slot of two
    rows' length in device memory."""
    N = h * w
    side = 2 * radius + 1
    slots = side * side if radius > 0 and side * side < N else N
    row_len = (1 + min(n_slots, T - 2)) * slots
    fixed = 4 * (256 * 34 + D + 24)
    return min(B * N, DENSE_BLOCKS), row_len, fixed + 8 * row_len <= 227 * 1024


def tile_box(plan: TilePlan, h: int, w: int, radius: int, ty: int,
             tx: int) -> tuple[int, int]:
    """(y0, x0), the first patch row and column of tile (ty, tx)'s key box:
    its queries' windows, shifted inside the grid."""
    x0 = 0 if plan.box_w == w else min(max(tx * TILE - radius, 0), w - plan.box_w)
    y0 = 0 if plan.box_h == h else min(max(ty * TILE - radius, 0), h - plan.box_h)
    return y0, x0


def propagate_labels_batch_plain(features, first_seg, n_last: int = 7,
                                 radius: int = 6, topk: int = 5,
                                 temperature: float = 0.1,
                                 spatial_size: tuple[int, int] | None = None):
    """The plain version: ``propagate_labels`` clip by clip."""
    return torch.stack([
        propagate_labels(f, s, n_last=n_last, radius=radius, topk=topk,
                         temperature=temperature, spatial_size=spatial_size)
        for f, s in zip(features, first_seg)
    ])


def _normalised(features):
    return features / (torch.linalg.vector_norm(features, dim=-1, keepdim=True) + _EPS)


def _context(t: int, n_slots: int) -> list[int]:
    """The live context frames of target frame t: 0 and the recent ones."""
    return [0] + list(range(max(1, t - n_slots), t))


def _dense_rows(feats_n, t, n_slots, nbhd, temperature):
    """[B, N, live * N] affinity rows of target frame t (the plain version's
    without its dead slots) and their keys (frame * N + patch)."""
    B, _, N, _ = feats_n.shape
    acc_t = torch.promote_types(feats_n.dtype, torch.float32)
    frames = _context(t, n_slots)
    aff = torch.einsum("bnd,bcmd->bncm", feats_n[:, t].to(acc_t),
                       feats_n[:, frames].to(acc_t))
    aff = torch.exp(aff / temperature) * nbhd[None, :, None].to(acc_t)
    keys = (torch.tensor(frames, device=aff.device)[:, None] * N
            + torch.arange(N, device=aff.device)[None]).reshape(-1)
    return aff.reshape(B, N, -1), keys


def compact_rows_plain(features, n_last: int = 7, radius: int = 6, topk: int = 5,
                       temperature: float = 0.1,
                       spatial_size: tuple[int, int] | None = None):
    """Phase (a) of the kernel in plain PyTorch: for every target frame's
    affinity rows, the kept entries (affinity >= the row's k-th largest,
    duplicates counted, and > 0) as at most ``ROOM`` keys (frame * N +
    patch, -1 where empty) with their normalised weights, and their count;
    -1 for a row whose kept set does not fit, whose k exceeds ``LIST`` or
    whose tile's key box is wider than a chunk, which goes to the exact
    dense pass. features [B, T, N, D] ->
    keys [B, T-1, N, ROOM] int64, weights [B, T-1, N, ROOM] f32, counts
    [B, T-1, N] int64."""
    B, T, N, _ = features.shape
    h, w = _grid(N, spatial_size)
    nbhd = neighborhood_mask(h, w, radius, features.device)
    feats_n = _normalised(features)
    n_slots = context_slots(T, n_last)
    plan = tile_plan(h, w, max(radius, 0))
    keys = torch.full((B, T - 1, N, ROOM), -1, dtype=torch.int64, device=features.device)
    weights = torch.zeros((B, T - 1, N, ROOM), dtype=torch.float32, device=features.device)
    counts = torch.empty((B, T - 1, N), dtype=torch.int64, device=features.device)
    for t in range(1, T):
        aff, row_keys = _dense_rows(feats_n, t, n_slots, nbhd, temperature)
        kth = kth_largest_value(aff, topk)[..., None]
        kept = (aff >= kth) & (aff > 0)
        n = kept.sum(-1)
        denom = torch.where(aff >= kth, aff, 0).sum(-1, keepdim=True) + _EPS
        over = (n > ROOM) | (topk > LIST) | (plan.chunk_rows == 0)
        counts[:, t - 1] = torch.where(over, -1, n)
        # the kept entries first, in key order
        order = torch.argsort((~kept).to(torch.int8), dim=-1, stable=True)[..., :ROOM]
        take = torch.gather(kept, -1, order) & ~over[..., None]
        cols = order.shape[-1]                       # a row shorter than ROOM
        keys[:, t - 1, :, :cols] = torch.where(take, row_keys[order], -1)
        weights[:, t - 1, :, :cols] = torch.where(
            take, torch.gather(aff / denom, -1, order), 0)
    return keys, weights, counts


def seg_from_compact_plain(keys, weights, counts, features, first_seg,
                           n_last: int = 7, radius: int = 6, topk: int = 5,
                           temperature: float = 0.1,
                           spatial_size: tuple[int, int] | None = None):
    """Phase (b) in plain PyTorch: seg_t of every query from its compact row
    (the label maps of each kept key, frame 0's or an earlier output,
    weighted), one frame after the other; a row flagged -1 through its
    dense row (the exact pass). -> [B, T-1, K, N] f32."""
    B, T, N, _ = features.shape
    K = first_seg.shape[1]
    h, w = _grid(N, spatial_size)
    nbhd = neighborhood_mask(h, w, radius, features.device)
    feats_n = _normalised(features)
    n_slots = context_slots(T, n_last)
    maps = [first_seg.float()]                       # frame j's [B, K, N]
    for t in range(1, T):
        flat = torch.stack(maps, 1).permute(0, 2, 1, 3).reshape(B, K, -1)   # [B, K, t*N]
        k_t, w_t = keys[:, t - 1], weights[:, t - 1]
        gathered = torch.gather(flat, 2, k_t.clamp(min=0).reshape(B, 1, -1).expand(B, K, -1))
        seg = (gathered.reshape(B, K, N, ROOM) * w_t[:, None]).sum(-1)
        over = counts[:, t - 1] < 0
        if bool(over.any()):
            aff, row_keys = _dense_rows(feats_n, t, n_slots, nbhd, temperature)
            kth = kth_largest_value(aff, topk)[..., None]
            p = torch.where(aff >= kth, aff, 0)
            p = p / (p.sum(-1, keepdim=True) + _EPS)
            dense = torch.einsum("bkc,bnc->bkn", flat[:, :, row_keys], p)
            seg = torch.where(over[:, None], dense, seg)
        maps.append(seg)
    return torch.stack(maps[1:], 1)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 (10 explicit mantissa bits), to nearest, ties
    away from zero (cvt.rna.tf32.f32): the low 13 bits of the pattern
    cleared after adding half of their weight."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def propagate_labels_batch_cuda(features, first_seg, n_last: int = 7,
                                radius: int = 6, topk: int = 5,
                                temperature: float = 0.1,
                                spatial_size: tuple[int, int] | None = None):
    """Kernel 3. features [B, T, N, D] (normalised in their own dtype; bf16
    is read as bf16, any other dtype as f32 through its TF32 split),
    first_seg [B, K, N] -> [B, T-1, K, N] f32."""
    kernel_lib.require_no_grad("propagate_labels_batch", features, first_seg)
    if features.device.type == "cpu":
        return propagate_labels_batch_plain(
            features, first_seg, n_last=n_last, radius=radius, topk=topk,
            temperature=temperature, spatial_size=spatial_size)
    return _launch(features, first_seg, n_last, radius, topk, temperature,
                   spatial_size)[0]


def propagate_labels_batch_stats(features, first_seg, n_last: int = 7,
                                 radius: int = 6, topk: int = 5,
                                 temperature: float = 0.1,
                                 spatial_size: tuple[int, int] | None = None):
    """``propagate_labels_batch_cuda`` with what its rows took: -> (output,
    the rows of each target frame that went through the exact dense pass
    ([T-1] int32 on the features' device), the kernel's scratch bytes). On
    the CPU: the plain version, the mirror's count (``compact_rows_plain``)
    and no scratch."""
    kernel_lib.require_no_grad("propagate_labels_batch", features, first_seg)
    if features.device.type == "cpu":
        kw = dict(n_last=n_last, radius=radius, topk=topk, temperature=temperature,
                  spatial_size=spatial_size)
        counts = compact_rows_plain(features, **kw)[2]
        return (propagate_labels_batch_plain(features, first_seg, **kw),
                (counts < 0).sum((0, 2)).to(torch.int32), 0)
    return _launch(features, first_seg, n_last, radius, topk, temperature,
                   spatial_size)


def _launch(features, first_seg, n_last, radius, topk, temperature, spatial_size):
    """The kernel on CUDA tensors -> (output, overflow rows a target frame,
    scratch bytes)."""
    if features.dim() != 4 or first_seg.dim() != 3:
        raise ValueError(f"propagate_labels_batch: expected [B, T, N, D] and "
                         f"[B, K, N], got {tuple(features.shape)}, "
                         f"{tuple(first_seg.shape)}")
    B, T, N, D = features.shape
    K = first_seg.shape[1]
    if first_seg.shape[0] != B or first_seg.shape[2] != N or T < 2:
        raise ValueError(f"propagate_labels_batch: shapes "
                         f"{tuple(features.shape)} / {tuple(first_seg.shape)}")
    if D % 32:
        raise ValueError(f"propagate_labels_batch: the kernel takes D % 32 == 0, "
                         f"got D={D}")
    h, w = _grid(N, spatial_size)
    radius = max(int(radius), 0)         # the plain mask: radius <= 0 is no mask
    n_slots = context_slots(T, n_last)
    plan = tile_plan(h, w, radius)
    feats_n = _normalised(features)
    bf16 = feats_n.dtype == torch.bfloat16
    if bf16:
        # the bf16 products take 64 features a step: zero features add nothing
        if D % 64:
            feats_n = torch.nn.functional.pad(feats_n, (0, -D % 64))
        feats_n = feats_n.contiguous()
        hi = lo = None
    else:
        feats_n = feats_n.float().contiguous()
        hi = _tf32(feats_n)
        lo = _tf32(feats_n - hi)
    seg0 = first_seg.float().contiguous()
    kernel_lib.require_cuda("propagate_labels_batch", feats_n, seg0)
    dev = features.device
    dense_blocks, row_len, in_smem = dense_plan(B, T, h, w, feats_n.shape[-1], radius,
                                                n_slots)
    # compact rows (key, weight as int32 pairs), their counts, the overflow
    # rows of each target frame and their number, the dense pass's rows
    # where they do not fit shared memory
    entries = torch.empty((B, T - 1, N, ROOM, 2), dtype=torch.int32, device=dev)
    counts = torch.empty((B, T - 1, N), dtype=torch.int32, device=dev)
    ovf_rows = torch.empty((T - 1, B * N), dtype=torch.int32, device=dev)
    ovf_count = torch.empty((T - 1,), dtype=torch.int32, device=dev)
    dense_rows = torch.empty((0 if in_smem else dense_blocks, 2 * row_len),
                             dtype=torch.float32, device=dev)
    out = torch.empty((B, T - 1, K, N), dtype=torch.float32, device=dev)
    kernel_lib.launch(
        "propagation", "tt_propagate_labels", dev, feats_n.data_ptr(),
        None if hi is None else hi.data_ptr(), None if lo is None else lo.data_ptr(),
        seg0.data_ptr(), out.data_ptr(), entries.data_ptr(), counts.data_ptr(),
        ovf_rows.data_ptr(), ovf_count.data_ptr(),
        None if in_smem else dense_rows.data_ptr(), int(bf16), B,
        T, h, w, feats_n.shape[-1], K, n_slots, radius, topk, plan.box_h, plan.box_w,
        plan.chunk_rows, dense_blocks, row_len, float(temperature))
    scratch = sum(t.numel() * t.element_size()
                  for t in (entries, counts, ovf_rows, ovf_count, dense_rows))
    return out, ovf_count, scratch


def device_plan(h: int, w: int, radius: int) -> TilePlan:
    """The C side's own plan (``tt_propagate_plan``), for the checks."""
    out = (ctypes.c_int * 6)()
    if kernel_lib.library().tt_propagate_plan(h, w, radius, out) != 0:
        raise ValueError(f"tt_propagate_plan refused {h}x{w}, radius {radius}")
    return TilePlan(*out)
