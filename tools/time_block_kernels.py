#!/usr/bin/env python3
"""Device times of the port's block kernels (K1, K2/K9, K7, K8), of the
flash core (K5/6) and of kernel 10 at the main paths' shapes, for one or
several copies of the kernel sources, in turns inside one process on one
card.

    python tools/time_block_kernels.py [--slices 1,2,3] [--host] [csrc_dir ...]

Without a directory: the package's own ``timetuning_tpu_torch/csrc``. With
several (copies of it with one edit each, kept in a gitignored directory),
each is built and timed in the order given and then in the reverse order, so
that two variants are compared on one card under one power limit. Times are
CUDA events over 20 launches queued behind a device-side sleep
(``card.cuda_ms``): device times, whatever the host does.

The flash core (K5/6, bf16, heads of 64) on the strided views of a qkv
buffer at the S/8 serving request (25 x 6 heads x 3,137 tokens), beside
PyTorch's SDPA and the plain version, and at the eval group's 50 x 6 x 3,137
and DINOv2 ViT-g's request (25 x 24 x 1,029): the form the card's waves pick
and each form forced (2 consumer warpgroups a block, 3), with each form's
waves (query rows a block times its waves of blocks over the SMs), what the
host's rule weighs.

The MLP branch (K2 / K9) is timed whole and as its two launches apart (fc1
with the LayerNorm prologue and the GELU epilogue; fc2 with the residual).

``--slices``: also time K7, K8, fc1 without the GELU (384 -> 1,536 with the
prologue), the MLP's fc1 + GELU and its fc2 (1,536 -> 384 with the residual)
with the GEMM tile's plan forced to each of these slice counts (capped at
the product's tiles), beside the plan's own choice: the measurements
``ops/fused_block.gemm_plan``'s cost constants come from. ``--host``: the host's time for one call of each wrapper
at a tiny shape, without synchronising (what a launch costs the Python side).
``--g14``: in each directory's turn, DINOv2 ViT-g's block at a request of
25 frames at 448 (25 x 1,029 rows, D 1,536, SwiGLU hidden 4,096, 24 heads of
64), on the same inputs each turn: LN1 + qkv (the
LayerNorm pass and the streamed tile), proj + residual, the SwiGLU MLP, the
flash core; each beside its PyTorch library form (F.layer_norm, F.linear,
F.silu in bf16) and its plain version (the f32 composition); the device time
of each kernel of the two DINOv2 entries (``torch.profiler``); the SwiGLU and
qkv products with a tile a block (the plan's slices before slices by waves).
``--v3``: in each directory's turn, DINOv3 ViT-7B's block at a request of 8
frames at 896 (8 x 3,141 rows, D 4,096, SwiGLU hidden 8,192, 32 heads of 128,
LayerNorm eps 1e-5): LN1 + qkv + RoPE (the LayerNorm pass of a block a row
and the RoPE tile), the flash core at heads of 128, proj + residual, the
SwiGLU MLP; each beside its library form and its plain version, and the
device time of each kernel of the RoPE and SwiGLU entries (the pass's among
them).
``--sam``: in each directory's turn, SAM ViT-H's block at a request of 8
frames at 1,024 (8 x 4,096 grid rows, 8 x 4,900 window rows, D 1,280, MLP
5,120, 16 heads of 80): LN1 + qkv into window order, the heads-of-80 core
with the bias over the windows (8 x 25 x 16 x 196) and over the grid (8 x
16 x 4,096), proj + residual, the GELU MLP at D 1,280; each beside its
library form (F.layer_norm and F.linear in bf16, the windows by pad and
permute; SDPA with the bias as an additive [.., S, S] mask; F.gelu) and its
plain version, with its least (``benchmark/counts_sam``), and the device
time of each kernel of the three entries.

Needs a CUDA card and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import card  # noqa: E402
from timetuning_tpu_torch.ops import attention as at  # noqa: E402
from timetuning_tpu_torch.ops import flash_attention as fa  # noqa: E402
from timetuning_tpu_torch.ops import fused_block as fb  # noqa: E402
from timetuning_tpu_torch.ops import kernel_lib  # noqa: E402

SHAPES = {"50x3137": (50, 3137), "50x197": (50, 197), "128x197": (128, 197)}
D, HEADS = 384, 6


def inputs(dev, gen, B, S):
    def r(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def w(n_in, n_out):     # as models/vit.Block passes a Linear weight
        return (r(n_out, n_in) / n_in ** 0.5).t().to(torch.bfloat16)

    return dict(
        x=r(B, S, D).bfloat16(), y=r(B, S, D).bfloat16(), h=r(B, S, 4 * D).bfloat16(),
        ln=(1 + 0.1 * r(D), 0.1 * r(D)), qkv=(w(D, 3 * D), 0.1 * r(3 * D)),
        proj=(w(D, D), 0.1 * r(D)), fc1=(w(D, 4 * D), 0.1 * r(4 * D)),
        fc2=(w(4 * D, D), 0.1 * r(D)), q3=r(B, S, 3, HEADS, 64).bfloat16())


def kernels(i, S):
    q, k, v = (i["q3"][:, :, j].permute(0, 2, 1, 3) for j in range(3))
    fns = {
        "ln_dense": lambda: fb.ln_dense_rows(i["x"], *i["ln"], *i["qkv"]),
        "dense_residual": lambda: fb.dense_residual_rows(i["y"], i["x"], *i["proj"]),
        "mlp": lambda: fb.mlp_rows(i["x"], *i["ln"], *i["fc1"], *i["fc2"]),
        "mlp fc1+gelu": lambda: fb.mlp_hidden_rows(i["x"], *i["ln"], *i["fc1"]),
        "mlp fc2": lambda: fb.mlp_out_rows(i["h"], i["x"], *i["fc2"]),
    }
    if S <= at.WHOLE_SEQUENCE_TOKENS:
        fns["attention_block"] = lambda: fb.attention_block_branch(
            i["x"], *i["ln"], *i["qkv"], *i["proj"], HEADS)
        fns["mha"] = lambda: at.attention_mha(q, k, v)
    return fns


def products(i):
    return {
        "ln_dense 384->1152": lambda: fb.ln_dense_rows(i["x"], *i["ln"], *i["qkv"]),
        "dense_residual 384->384": lambda: fb.dense_residual_rows(i["y"], i["x"], *i["proj"]),
        "ln_dense 384->1536": lambda: fb.ln_dense_rows(i["x"], *i["ln"], *i["fc1"]),
        "mlp fc1+gelu 384->1536": lambda: fb.mlp_hidden_rows(i["x"], *i["ln"], *i["fc1"]),
        "mlp fc2 1536->384": lambda: fb.mlp_out_rows(i["h"], i["x"], *i["fc2"]),
    }


def forced_slices(ns):
    """``fused_block._slices`` with every plan's slices forced to ``ns``,
    capped at the product's units (a wide product keeps one item a unit)."""
    def slices(device, M, N, K, ln, epi=fb.EPI_RESIDUAL):
        p = fb.gemm_plan(M, N, K, ln, kernel_lib.sm_count(0), epi)
        return p.n_units if p.unit_cols == fb.GEMM_WIDE_COLS else min(ns, p.n_units)

    return slices


def g14(dev, label):
    M, D, Hd, H = 25 * 1029, 1536, 4096, 24
    gen = torch.Generator(device=dev).manual_seed(1)     # the same inputs each call

    def r(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def w(n_in, n_out):
        return (r(n_out, n_in) / n_in ** 0.5).t().to(torch.bfloat16)

    x, y = r(1, M, D).bfloat16(), r(1, M, D).bfloat16()
    ln = (1 + 0.1 * r(D), 0.1 * r(D))
    qkv, proj = (w(D, 3 * D), 0.1 * r(3 * D)), (w(D, D), 0.1 * r(D))
    mlp = (*ln, w(D, 2 * Hd), 0.1 * r(2 * Hd), w(Hd, D), 0.1 * r(D))
    q3 = r(25, 1029, 3, H, 64).bfloat16()
    q, k, v = (q3[:, :, j].permute(0, 2, 1, 3) for j in range(3))
    F = torch.nn.functional

    def lib_swiglu():
        a, b = F.linear(F.layer_norm(x, (D,), *(t.bfloat16() for t in ln), 1e-6),
                        mlp[2].t(), mlp[3].bfloat16()).chunk(2, dim=-1)
        return x + F.linear(F.silu(a) * b, mlp[4].t(), mlp[5].bfloat16())

    rows = {
        "ln_wide_dense (LN1 + qkv)": (
            lambda: fb.ln_dense_rows(x, *ln, *qkv),
            lambda: F.linear(F.layer_norm(x, (D,), *(t.bfloat16() for t in ln), 1e-6),
                             qkv[0].t(), qkv[1].bfloat16()),
            lambda: fb.ln_dense_xla(x, *ln, *qkv)),
        "dense_residual (proj)": (
            lambda: fb.dense_residual_rows(y, x, *proj),
            lambda: x + F.linear(y, proj[0].t(), proj[1].bfloat16()),
            lambda: fb.dense_residual_xla(y, x, *proj)),
        "swiglu_mlp": (lambda: fb.swiglu_rows(x, *mlp), lib_swiglu,
                       lambda: fb.swiglu_block_xla(x, *mlp)),
        "flash (1,029 tokens)": (
            lambda: fa.flash_attention(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v),
            lambda: fa.flash_attention_xla(q, k, v)),
    }
    for name, (kern, lib, plain) in rows.items():
        print(f"{label} g14 {name} ms: kernel {card.cuda_ms(kern):.4f}  library "
              f"{card.cuda_ms(lib):.4f}  plain {card.cuda_ms(plain, reps=3):.4f}", flush=True)
    from torch.profiler import ProfilerActivity, profile

    for name in ("ln_wide_dense (LN1 + qkv)", "swiglu_mlp"):
        fn = rows[name][0]
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        by = {e.key[:60]: e.device_time_total / 5e3 for e in prof.key_averages()
              if e.device_time_total > 0}
        print(f"{label} g14 {name} kernels ms: "
              + "  ".join(f"{k} {v:.4f}" for k, v in by.items()),
              flush=True)
    plan = fb._slices
    fb._slices = forced_slices(1 << 20)
    for name in ("ln_wide_dense (LN1 + qkv)", "swiglu_mlp"):
        print(f"{label} g14 {name} with a tile a block, ms: {card.cuda_ms(rows[name][0]):.4f}",
              flush=True)
    fb._slices = plan


def v3(dev, label):
    B, S, D, Hd, H, prefix, eps = 8, 3141, 4096, 8192, 32, 5, 1e-5
    gen = torch.Generator(device=dev).manual_seed(1)     # the same inputs each call

    def r(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def w(n_in, n_out):
        return (r(n_out, n_in) / n_in ** 0.5).t().to(torch.bfloat16)

    from timetuning_tpu_torch.models import vit

    x, y = r(B, S, D).bfloat16(), r(B, S, D).bfloat16()
    ln = (1 + 0.1 * r(D), 0.1 * r(D))
    qkv, proj = w(D, 3 * D), (w(D, D), 0.1 * r(D))
    mlp = (*ln, w(D, 2 * Hd), 0.1 * r(2 * Hd), w(Hd, D), 0.1 * r(D))
    cos, sin = vit.rope_table(vit.rope_periods(128, 100.0).to(dev), 56, 56)
    q3 = r(B, S, 3, H, 128).bfloat16()
    q, k, v = (q3[:, :, j].permute(0, 2, 1, 3) for j in range(3))
    F = torch.nn.functional
    lnb = tuple(t.bfloat16() for t in ln)

    def lib_rope():
        h = F.linear(F.layer_norm(x, (D,), *lnb, eps), qkv.t()).reshape(B, S, 3, H, 128)
        qk = h[:, prefix:, :2]
        rot = torch.cat([-qk[..., 64:], qk[..., :64]], dim=-1)
        c, s_ = cos[:, None, None].bfloat16(), sin[:, None, None].bfloat16()
        return torch.cat([h[:, :prefix, :2], qk * c + rot * s_], dim=1)

    def lib_swiglu():
        h = F.layer_norm(x, (D,), *lnb, eps)
        a, b = F.linear(h, mlp[2].t(), mlp[3].bfloat16()).chunk(2, dim=-1)
        return x + F.linear(F.silu(a) * b, mlp[4].t(), mlp[5].bfloat16())

    rows = {
        "ln_rope_dense (LN1 + qkv + RoPE)": (
            lambda: fb.ln_rope_dense_rows(x, *ln, qkv, None, cos, sin, H, prefix, eps),
            lib_rope,
            lambda: fb.ln_rope_dense_xla(x, *ln, qkv, None, cos, sin, H, prefix, eps)),
        "flash_d128 (3,141 tokens)": (
            lambda: fa.flash_attention(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v),
            lambda: fa.flash_attention_xla(q, k, v)),
        "dense_residual (proj)": (
            lambda: fb.dense_residual_rows(y, x, *proj),
            lambda: x + F.linear(y, proj[0].t(), proj[1].bfloat16()),
            lambda: fb.dense_residual_xla(y, x, *proj)),
        "swiglu_mlp": (lambda: fb.swiglu_rows(x, *mlp, eps), lib_swiglu,
                       lambda: fb.swiglu_block_xla(x, *mlp, eps)),
    }
    for name, (kern, lib, plain) in rows.items():
        print(f"{label} v3 {name} ms: kernel {card.cuda_ms(kern):.4f}  library "
              f"{card.cuda_ms(lib):.4f}  plain {card.cuda_ms(plain, warmup=1, reps=2):.4f}",
              flush=True)
    for name in ("ln_rope_dense (LN1 + qkv + RoPE)", "swiglu_mlp"):
        by = card.kernel_times(rows[name][0])
        print(f"{label} v3 {name} kernels ms: "
              + "  ".join(f"{k[:60]} {n:g}x {t:.4f}" for k, (n, t) in by.items()), flush=True)


def sam(dev, label):
    from benchmark import counts, counts_sam

    B, G, win, D, Hd, H = 8, 64, 14, 1280, 5120, 16
    gen = torch.Generator(device=dev).manual_seed(3)     # the same inputs each call

    def r(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def w(n_in, n_out):
        return (r(n_out, n_in) / n_in ** 0.5).t().to(torch.bfloat16)

    F = torch.nn.functional
    x, y = r(B, G * G, D).bfloat16(), r(B, G * G, D).bfloat16()
    ln = (1 + 0.1 * r(D), 0.1 * r(D))
    lnb = tuple(t.bfloat16() for t in ln)
    qkv_w, qkv_b = w(D, 3 * D), 0.02 * r(3 * D)
    proj = (w(D, D), 0.1 * r(D))
    mlp = (*ln, w(D, Hd), 0.1 * r(Hd), w(Hd, D), 0.1 * r(D))
    qkv_win = r(B * 25, win * win, 3 * D).bfloat16()
    qkv_grid = r(B, G * G, 3 * D).bfloat16()
    tabs = {K: tuple((0.08 * r(2 * K - 1, 80)).bfloat16() for _ in range(2)) for K in (win, G)}

    def lib_window_qkv():
        h = fa.window_rows(F.layer_norm(x, (D,), *lnb, 1e-6), G, win)
        return F.linear(h, qkv_w.t(), qkv_b.bfloat16())

    def lib_relpos(qkv, K, window):
        # SDPA with SAM's bias as an additive mask, the [.., S, S] bias made
        N, S, _ = qkv.shape
        t = qkv.view(N, S, 3, H, 80)
        q, k, v = (t[:, :, i].transpose(1, 2) for i in range(3))
        idx = fa.rel_index(K, dev)
        rq = q.reshape(N, H, K, K, 80)
        bh = torch.einsum("nhyxc,ykc->nhyxk", rq, tabs[K][0][idx])
        bw = torch.einsum("nhyxc,xkc->nhyxk", rq, tabs[K][1][idx])
        bias = (bh[..., :, None] + bw[..., None, :]).reshape(N, H, S, S)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias).transpose(1, 2)
        o = o.reshape(N, S, D)
        return fa.grid_rows(o, G, window) if window else o

    def lib_mlp():
        h = F.gelu(F.linear(F.layer_norm(x, (D,), *lnb, 1e-6), mlp[2].t(), mlp[3].bfloat16()))
        return x + F.linear(h, mlp[4].t(), mlp[5].bfloat16())

    rows_w = B * counts_sam.window_rows(G, win)
    least = {       # the work the result needs: the grid's rows and queries only
        "ln_window_dense (LN1 + qkv, window order)": (
            2 * 2 * B * G * G * D / counts.MEM_BYTES_PER_S
            + counts.least_s(2 * B * G * G * D * 3 * D,
                             2 * (B * G * G * D + 3 * D * D + rows_w * 3 * D))),
        "flash_relpos windowed (8 x 25 x 16 x 196)": counts.least_s(
            B * counts_sam.attn_flops(G * G, 196, win, D), B * 2 * (2 * 4096 + 2 * 4900) * D),
        "flash_relpos global (8 x 16 x 4,096)": counts.least_s(
            B * counts_sam.attn_flops(G * G, G * G, G, D), B * 2 * 4 * 4096 * D),
        "dense_residual (proj, D 1,280)": counts.least_s(
            2 * B * G * G * D * D, 2 * (3 * B * G * G * D + D * D)),
        "mlp_wide (GELU MLP, D 1,280)": counts_sam.gelu_mlp_least_s(B * G * G, D, Hd),
    }
    rows = {
        "ln_window_dense (LN1 + qkv, window order)": (
            lambda: fb.ln_window_dense_rows(x, *ln, qkv_w, qkv_b, G, win), lib_window_qkv,
            lambda: fb.ln_window_dense_xla(x, *ln, qkv_w, qkv_b, G, win)),
        "flash_relpos windowed (8 x 25 x 16 x 196)": (
            lambda: fa.relpos_attention(qkv_win, *tabs[win], H, G, win),
            lambda: lib_relpos(qkv_win, win, win),
            lambda: fa.relpos_attention_xla(qkv_win, *tabs[win], H, G, win)),
        "flash_relpos global (8 x 16 x 4,096)": (
            lambda: fa.relpos_attention(qkv_grid, *tabs[G], H, G, 0),
            lambda: lib_relpos(qkv_grid, G, 0),
            lambda: fa.relpos_attention_xla(qkv_grid[:2], *tabs[G], H, G, 0)),
        "dense_residual (proj, D 1,280)": (
            lambda: fb.dense_residual_rows(y, x, *proj),
            lambda: x + F.linear(y, proj[0].t(), proj[1].bfloat16()),
            lambda: fb.dense_residual_xla(y, x, *proj)),
        "mlp_wide (GELU MLP, D 1,280)": (lambda: fb.mlp_rows(x, *mlp), lib_mlp,
                                         lambda: fb.mlp_block_xla(x, *mlp)),
    }
    for name, (kern, lib, plain) in rows.items():
        note = " (2 of 8 frames)" if "global" in name else ""
        print(f"{label} sam {name} ms: kernel {card.cuda_ms(kern):.4f}  library "
              f"{card.cuda_ms(lib):.4f}  plain{note} {card.cuda_ms(plain, warmup=1, reps=2):.4f}"
              f"  least {1e3 * least[name]:.4f}", flush=True)
    for name in ("ln_window_dense (LN1 + qkv, window order)",
                 "flash_relpos windowed (8 x 25 x 16 x 196)",
                 "flash_relpos global (8 x 16 x 4,096)", "mlp_wide (GELU MLP, D 1,280)"):
        by = card.kernel_times(rows[name][0])
        print(f"{label} sam {name} kernels ms: "
              + "  ".join(f"{k[:60]} {n:g}x {t:.4f}" for k, (n, t) in by.items()), flush=True)


FLASH_SHAPES = {"25x6x3137": (25, 6, 3137), "50x6x3137": (50, 6, 3137),
                "25x24x1029": (25, 24, 1029)}


def flash(dev, label):
    F = torch.nn.functional
    sms = kernel_lib.sm_count(dev)
    for name, (B, H, S) in FLASH_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(2)     # the same inputs each call
        q3 = torch.randn(B, S, 3, H, 64, device=dev, generator=gen).bfloat16()
        q, k, v = (q3[:, :, j].permute(0, 2, 1, 3) for j in range(3))
        row = {"kernel": card.cuda_ms(lambda: fa.flash_attention(q, k, v))}
        for wg in (2, 3):
            row[f"{wg} warpgroups"] = card.cuda_ms(
                lambda wg=wg: fa.flash_attention_form(q, k, v, None, wg))
        row["library"] = card.cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        if name == "25x6x3137":
            row["plain"] = card.cuda_ms(lambda: fa.flash_attention_xla(q, k, v), reps=3)
        waves = {rows: -(-(-(-S // rows) * B * H) // sms) * rows for rows in (128, 192)}
        print(f"{label} flash {name} ms: " + "  ".join(f"{k} {t:.4f}" for k, t in row.items())
              + f"  (waves x rows: 2 warpgroups {waves[128]}, 3 {waves[192]})", flush=True)


def line(label, fns):
    print(f"{label}: " + "  ".join(f"{k} {card.cuda_ms(f):.4f}" for k, f in fns.items()),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("csrc", nargs="*", type=Path)
    ap.add_argument("--slices", default="")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--g14", action="store_true")
    ap.add_argument("--v3", action="store_true")
    ap.add_argument("--sam", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_block_kernels: needs a CUDA card")
    print(card.nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    data = {name: inputs(dev, gen, B, S) for name, (B, S) in SHAPES.items()}

    dirs = args.csrc or [kernel_lib.CSRC_DIR]
    for d in dirs + (dirs[::-1] if len(dirs) > 1 else []):
        kernel_lib._lib = None
        kernel_lib.CSRC_DIR = d.resolve()
        kernel_lib.library()
        for name, (_, S) in SHAPES.items():
            line(f"{d.name} {name} ms", kernels(data[name], S))
        flash(dev, d.name)
        if args.g14:
            g14(dev, d.name)
        if args.v3:
            v3(dev, d.name)
        if args.sam:
            sam(dev, d.name)

    if args.slices:
        plan = fb._slices
        for name in SHAPES:
            line(f"{dirs[0].name} {name} the plan's slices, ms", products(data[name]))
            for ns in (int(v) for v in args.slices.split(",")):
                fb._slices = forced_slices(ns)
                line(f"{dirs[0].name} {name} slices={ns} ms", products(data[name]))
            fb._slices = plan

    if args.host:
        tiny = inputs(dev, gen, 1, 16)
        fns = kernels(tiny, 16)
        fns["F.linear (one library call)"] = lambda: torch.nn.functional.linear(
            tiny["x"], tiny["proj"][0].t())
        for name, fn in fns.items():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            best = float("inf")
            for _ in range(5):
                t0 = time.perf_counter()
                for _ in range(200):
                    fn()
                best = min(best, (time.perf_counter() - t0) / 200)
                torch.cuda.synchronize()
            print(f"host us a call at [1, 16, {D}], no synchronise: {name} {best * 1e6:.1f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
