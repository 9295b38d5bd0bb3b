"""Exact attention for long sequences: the flash kernel and its plain version.

Counterpart of ``timetuning_tpu/ops/flash_attention.py``. One CUDA kernel
(csrc/flash_attention.cu) replaces both of its TPU kernels, the K/V-resident
``_flash_kernel`` (:47) and the K/V-streamed ``_flash_kernel_stream``
(:154): a Hopper SM's shared memory holds a few key tiles, not a head's
whole K/V, so the kernel always streams them. Heads of 64 or 32, in bf16 or
f32; heads of 128 (DINOv3 ViT-7B) in bf16 only, a form of their own
(``flash_bf16_d128_kernel``, counted as ``flash_d128``): an f32 input at 128
raises. Its backward is JAX's (``_chunked_bwd``, :274-327), plain torch:
``flash_attention_bwd``, the analytic softmax-attention gradient streamed
over query chunks.

Layout is JAX's, q ``[B, H, Sq, Dh]`` and k, v ``[B, H, Sk, Dh]``, and the
kernel reads strided views in place (the q, k, v slices of a qkv projection
need no copy); its output is a ``[B, H, Sq, Dh]`` view of a ``[B, Sq, H,
Dh]`` buffer, so merging the heads afterwards is free.

SAM ViT-H's attention (no JAX counterpart), ``relpos_attention``: heads of
80 in bf16 with SAM's decomposed relative-position bias, over the qkv rows
of a windowed block (a sequence a 14 x 14 window of the padded grid) or of
a global one (a sequence a frame's grid), its output the merged rows of the
grid (the windows merged and cropped by the kernel's stores; counted as
``flash_relpos``): sequences of up to 16 x 16 tokens (the windows) in the
resident form ``flash_relpos_kernel_windows``, one (sequence, head) pair at
a time with its bias tables made in the block; the 64 x 64 grid in
``flash_relpos_kernel`` after ``relpos_table_kernel``. Forward only: its
gradient is its plain version's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from timetuning_tpu_torch.ops import kernel_lib
from timetuning_tpu_torch.ops.attention import _aligned, _heads_fake, _heads_view, attention_xla

_NEG = -1e30

# the head widths the kernel takes, in bf16 and f32, and in bf16 only; any
# other raises
FLASH_HEAD_DIMS = (32, 64)
FLASH_BF16_HEAD_DIMS = (32, 64, 128)
KEY_TILE = 128      # keys a tile of the bf16 core (kBK)


def key_tile_counts(B: int, H: int, kv_len: int) -> tuple[int, int]:
    """The key tiles a launch of the bf16 core at heads of 32 or 64 walks,
    counted once for each (batch, head): (those whose softmax runs while the
    warpgroup's p @ v of the tile before is still in flight, all). Each
    (batch, head)'s first tile has no product before it: (n - 1) / n of its
    n tiles overlap, none where one tile holds every key."""
    n = -(-kv_len // KEY_TILE)
    return B * H * (n - 1), B * H * n


def flash_attention_xla(q, k, v, kv_len: int | None = None):
    """The plain version (``timetuning_tpu/ops/flash_attention.py:258-271``):
    scores in f32, keys at or beyond ``kv_len`` set to -1e30, softmax, the
    probabilities rounded to v's dtype before the f32 product with v."""
    if kv_len is None or kv_len == k.shape[2]:
        return attention_xla(q, k, v)[0]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    col = torch.arange(k.shape[2], device=q.device)
    s = torch.where(col[None, None, None, :] < kv_len, s,
                    torch.tensor(_NEG, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def flash_attention_bwd(q, k, v, g, kv_len: int | None = None,
                        block_q: int = 256):
    """The gradient of ``flash_attention`` in q, k and v, as JAX's
    ``_chunked_bwd`` (``timetuning_tpu/ops/flash_attention.py:274-327``):
    the analytic softmax-attention gradient in f32, over query chunks of
    ``block_q`` (the queries padded with zero rows, whose terms are zeros),
    keys at or beyond ``kv_len`` at -1e30, dk and dv summed over the chunks,
    so the peak is O(block_q * Sk) a head and never O(Sq * Sk)."""
    B, H, S, Dh = q.shape
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(Dh)
    Sqp = -(-S // block_q) * block_q
    qf = F.pad(q.float(), (0, 0, 0, Sqp - S))
    gf = F.pad(g.float(), (0, 0, 0, Sqp - S))
    kf, vf = k.float(), v.float()
    key_ok = (None if kv_len is None or kv_len == Sk
              else torch.arange(Sk, device=q.device) < kv_len)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for c in range(0, Sqp, block_q):
        q_c, g_c = qf[:, :, c:c + block_q], gf[:, :, c:c + block_q]
        s = torch.einsum("bhqd,bhkd->bhqk", q_c, kf) * scale
        if key_ok is not None:
            s = torch.where(key_ok, s, torch.tensor(_NEG, dtype=s.dtype,
                                                     device=s.device))
        p = torch.softmax(s, dim=-1)
        dv += torch.einsum("bhqk,bhqd->bhkd", p, g_c)
        dp = torch.einsum("bhqd,bhkd->bhqk", g_c, vf)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq[:, :, c:c + block_q] = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, q_c) * scale
    return dq[:, :, :S].to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashVJP(torch.autograd.Function):
    """The flash kernel forward, ``flash_attention_bwd`` backward (JAX's
    ``_flash_core`` custom VJP, :329-341)."""

    @staticmethod
    def forward(ctx, kernel, q, k, v, kv_len):
        ctx.kv_len = kv_len
        ctx.save_for_backward(q, k, v)
        return kernel(q, k, v, kv_len)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (None, *flash_attention_bwd(q, k, v, g, ctx.kv_len), None)


@kernel_lib.kernel_entry(
    "flash_attention", "(Tensor q, Tensor k, Tensor v, int? kv_len=None) -> Tensor",
    lambda q, k, v, kv_len=None: _heads_fake(q), lambda kernel, *a: _FlashVJP.apply(kernel, *a))
def flash_attention(q, k, v, kv_len: int | None = None):
    """Kernels 5 and 6 (csrc/flash_attention.cu). q [B, H, Sq, Dh], k and v
    [B, H, Sk, Dh], Dh 32 or 64, bf16 or f32, or 128 in bf16 (launches
    counted as ``flash_d128``); ``kv_len`` masks keys at or
    beyond it. Returns [B, H, Sq, Dh] in q's dtype, a view of a [B, Sq, H,
    Dh] buffer (on CPU tensors too: the custom op's fake has one layout)."""
    if q.device.type == "cpu":
        return _heads_view(flash_attention_xla(q, k, v, kv_len))
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: expected q [B, H, Sq, Dh] and k, v "
                         f"[B, H, Sk, Dh], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, Dh = q.shape
    Sk = k.shape[2]
    if k.shape[:2] != (B, H) or k.shape[3] != Dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch, heads or width")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: expected q, k, v all bf16 or all "
                         f"f32, got {q.dtype}, {k.dtype}, {v.dtype}")
    dims = FLASH_BF16_HEAD_DIMS if q.dtype == torch.bfloat16 else FLASH_HEAD_DIMS
    if Dh not in dims:
        raise ValueError(f"flash_attention: the kernel takes 32- or 64-wide heads, and "
                         f"128-wide in bf16; got Dh={Dh} in {q.dtype}")
    valid = Sk if kv_len is None else int(kv_len)
    if not 1 <= valid <= Sk:
        raise ValueError(f"flash_attention: kv_len={kv_len} outside [1, {Sk}]")
    kernel_lib.require_cuda("flash_attention", q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((B, Sq, H, Dh), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    kernel_lib.launch(
        "flash_d128" if Dh == 128 else "flash_attention", "tt_flash_attention", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), B, H, Sq, Sk, valid, Dh,
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    if q.dtype == torch.bfloat16 and Dh != 128:
        overlapped, tiles = key_tile_counts(B, H, valid)
        kernel_lib.WORK_COUNTS["flash_key_tiles_overlapped"] += overlapped
        kernel_lib.WORK_COUNTS["flash_key_tiles"] += tiles
    return out


RELPOS_HEAD_DIM = 80    # the head width of SAM's core (ViT-H's 16 heads of 80)
RELPOS_WINDOW_MAX_SIDE = 16   # the widest side of the resident form (SAM's windows, 14)
RELPOS_GRID_SIDE = 64   # the side of the streamed form (SAM's global grid at 1,024)


def window_rows(x, grid: int, window: int):
    """[B, G * G, D] rows of a G x G grid -> [B nw^2, window^2, D]: the grid
    padded with zero rows at the bottom and right to nw window (nw =
    ceil(G / window)), cut into windows, frame by frame, window by window
    (SAM's ``window_partition``)."""
    B, _, D = x.shape
    nw = -(-grid // window)
    pad = nw * window - grid
    g = F.pad(x.reshape(B, grid, grid, D), (0, 0, 0, pad, 0, pad))
    g = g.reshape(B, nw, window, nw, window, D).permute(0, 1, 3, 2, 4, 5)
    return g.reshape(B * nw * nw, window * window, D)


def grid_rows(w, grid: int, window: int):
    """The inverse of ``window_rows``, the padding cropped: [B nw^2,
    window^2, D] -> [B, G * G, D] (SAM's ``window_unpartition``)."""
    nw = -(-grid // window)
    D = w.shape[-1]
    B = w.shape[0] // (nw * nw)
    g = w.reshape(B, nw, nw, window, window, D).permute(0, 1, 3, 2, 4, 5)
    g = g.reshape(B, nw * window, nw * window, D)[:, :grid, :grid]
    return g.reshape(B, grid * grid, D)


def rel_index(K: int, device=None):
    """[K, K] rows of a [2 K - 1, Dh] table for query and key coordinates
    (a, b): a - b + K - 1 (SAM's ``get_rel_pos`` at equal sides)."""
    r = torch.arange(K, device=device)
    return r[:, None] - r[None, :] + K - 1


def relpos_attention_xla(qkv, rel_h, rel_w, num_heads: int, grid: int, window: int):
    """The plain version of ``relpos_attention``: for each sequence of the
    qkv rows, scores ``(q . k) / sqrt(Dh) + q . Rh[qh - kh + K - 1] + q .
    Rw[qw - kw + K - 1]`` in f32 from the operands' values (the unscaled q,
    the tables' values), softmax, the probabilities rounded to v's dtype
    before the f32 product with v, the heads merged; windowed (``window``
    > 0), the windows merged back into the grid and the padding cropped."""
    N, S, E = qkv.shape
    D = E // 3
    Dh = D // num_heads
    K = window or grid
    t = qkv.reshape(N, S, 3, num_heads, Dh)
    q, k, v = (t[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    qf = q.float()
    s = torch.einsum("nhqd,nhkd->nhqk", qf, k.float()) * Dh ** -0.5
    idx = rel_index(K, qkv.device)
    rq = qf.reshape(N, num_heads, K, K, Dh)
    bh = torch.einsum("nhyxc,ykc->nhyxk", rq, rel_h.float()[idx])
    bw = torch.einsum("nhyxc,xkc->nhyxk", rq, rel_w.float()[idx])
    s = (s.view(N, num_heads, K, K, K, K) + bh[..., :, None] + bw[..., None, :]).view(s.shape)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("nhqk,nhkd->nhqd", p.to(v.dtype).float(), v.float()).to(qkv.dtype)
    o = o.permute(0, 2, 1, 3).reshape(N, S, D)
    return grid_rows(o, grid, window) if window else o


def _relpos_fake(qkv, rel_h, rel_w, num_heads, grid, window):
    nw = -(-grid // window) if window else 1
    return qkv.new_empty((qkv.shape[0] // (nw * nw), grid * grid, qkv.shape[-1] // 3))


@kernel_lib.kernel_entry(
    "relpos_attention",
    "(Tensor qkv, Tensor rel_h, Tensor rel_w, int num_heads, int grid, int window) -> Tensor",
    _relpos_fake, kernel_lib.plain_vjp(relpos_attention_xla))
def relpos_attention(qkv, rel_h, rel_w, num_heads: int, grid: int, window: int):
    """SAM's attention with the decomposed relative-position bias
    (csrc/flash_attention.cu ``tt_flash_relpos``): ``qkv`` bf16 [N, K^2, 3
    D], the qkv rows of N sequences of a K x K grid each (q, k, v the first,
    second and third D columns, heads of 80); ``rel_h``, ``rel_w`` [2 K - 1,
    80] the block's tables. ``window`` 0: each sequence is a frame's G x G
    grid (K = G = ``grid``); else K = ``window`` and the sequences are the
    windows of each frame's grid padded to a multiple of the window
    (``window_rows``' order). Returns the merged heads [frames, G^2, D] in
    the grid's order, the windows merged and cropped. At K <= 16 (SAM's
    windows) one launch of the resident form, which makes the bias tables
    in its blocks (the pairs counted as ``relpos_windows_resident``); at K
    64 (SAM's grid) the tables [N, H, K^2, 2 K] are made in f32 by a small
    product before the core; any other K is refused."""
    if qkv.device.type == "cpu":
        return relpos_attention_xla(qkv, rel_h, rel_w, num_heads, grid, window)
    if qkv.dtype != torch.bfloat16 or qkv.dim() != 3:
        raise ValueError(f"relpos_attention: expected bf16 qkv [N, S, 3 D], got {qkv.dtype} "
                         f"{tuple(qkv.shape)}")
    N, S, E = qkv.shape
    D = E // 3
    K = window or grid
    nw = -(-grid // window) if window else 1
    if (E % 3 or D != num_heads * RELPOS_HEAD_DIM or S != K * K or N % (nw * nw)
            or (window and window > grid)
            or not (K <= RELPOS_WINDOW_MAX_SIDE or K == RELPOS_GRID_SIDE)):
        raise ValueError(f"relpos_attention: the core takes heads of {RELPOS_HEAD_DIM} over "
                         f"sequences of K x K tokens, K <= {RELPOS_WINDOW_MAX_SIDE} or "
                         f"K = {RELPOS_GRID_SIDE}; got K = {K} "
                         f"({'windows' if window else 'the grid'}"
                         f" of a {grid} x {grid} grid); got qkv {tuple(qkv.shape)}, "
                         f"{num_heads} heads")
    for t in (rel_h, rel_w):
        if tuple(t.shape) != (2 * K - 1, RELPOS_HEAD_DIM):
            raise ValueError(f"relpos_attention: tables {tuple(rel_h.shape)}, "
                             f"{tuple(rel_w.shape)} for [{2 * K - 1}, {RELPOS_HEAD_DIM}]")
    rh = rel_h.detach().to(torch.bfloat16).contiguous()
    rw = rel_w.detach().to(torch.bfloat16).contiguous()
    kernel_lib.require_cuda("relpos_attention", qkv, rh, rw)
    qkv = qkv.contiguous()
    t = qkv.view(N, S, 3, num_heads, RELPOS_HEAD_DIM)
    q, k, v = (t[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    resident = K <= RELPOS_WINDOW_MAX_SIDE    # the C entry takes a null `tables` for this form
    tables = None if resident else torch.empty(N, num_heads, S, 2 * K, dtype=torch.float32,
                                               device=qkv.device)
    out = torch.empty(N // (nw * nw), grid * grid, D, dtype=qkv.dtype, device=qkv.device)
    kernel_lib.launch(
        "flash_relpos", "tt_flash_relpos", qkv.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(), rw.data_ptr(),
        0 if tables is None else tables.data_ptr(), out.data_ptr(), N, num_heads, S, K, grid,
        window, *(s for u in (q, k, v) for s in u.stride()[:3]),
        out.stride(0), RELPOS_HEAD_DIM, out.stride(1))
    kernel_lib.WORK_COUNTS["relpos_windows" if window else "relpos_global"] += N * num_heads
    if resident:
        kernel_lib.WORK_COUNTS["relpos_windows_resident"] += N * num_heads
    return out


def flash_attention_form(q, k, v, kv_len: int | None = None, warpgroups: int = 3):
    """The bf16 core at heads of 32 or 64 in the form of ``warpgroups``
    consumer warpgroups a block (2: 128 query rows, 3: 192), whatever the
    shape; ``flash_attention`` picks the form by the card's waves. For the
    card's checks and the timing tools: it counts no launch and no tile."""
    kernel_lib.require_no_grad("flash_attention_form", q, k, v)
    kernel_lib.require_cuda("flash_attention_form", q, k, v)
    B, H, Sq, Dh = q.shape
    Sk = k.shape[2]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16) or Dh not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention_form: bf16 heads of 32 or 64, got Dh={Dh} "
                         f"in {q.dtype}")
    if warpgroups not in (2, 3):
        raise ValueError(f"flash_attention_form: 2 or 3 warpgroups, got {warpgroups}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((B, Sq, H, Dh), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    kernel_lib.launch(
        None, "tt_flash_attention_form", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Sq, Sk,
        Sk if kv_len is None else int(kv_len), Dh, warpgroups,
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    return out
