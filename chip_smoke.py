#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card and ``nvcc``, and
imports nothing of JAX. Phases, each of which raises on failure (exit code
1, no result line):

1. environment: versions, the card's name and power limit; no CUDA -> fail;
2. build of the hand-written kernels from ``timetuning_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once);
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the evals below, with its error bound and the times of both (CUDA
   events): kernels 1-4 at ViT-S/16 (50 frames at 224, two 25-frame clips
   of 480x854); the flash kernel in bf16 and f32 at [4 x 6 heads, 3,137
   tokens, 64], and at queries != keys with a key mask; the row kernels
   (ln_dense, dense_residual, mlp_rows) at 50 frames x 3,137 tokens; the
   propagation kernel at 56x56 patches;
4. 12 blocks of ViT-S/16 at 224 (4 frames) and of ViT-S/8 at 448 (1 frame,
   3,137 tokens) through the kernels against the plain bf16 forward on the
   host;
5. the DAVIS mask-propagation eval of the port (``cli/propagate``'s
   per-group compute) on two synthetic 25-frame 480x854 clips with seeded
   random weights, at ``dino-s16``/224 (a one-colour box) and at
   ``dino-s8``/448 (a textured box, see ``synthetic_clips``), each in bf16
   through the kernels and in f32; J&F of both, device frames/s, and a
   ``torch.profiler`` trace of three groups: device idle share and kernel
   time by name;
6. the linear probe (``cli/linear_probe``'s train and validate) at
   ``dino-s8``/448 in f32, a few SGD steps on in-memory synthetic batches:
   its attention runs the flash kernel in f32; finite loss and mIoU.

Launch counts are set to 0 just before each run of phases 5 and 6 and read
just after; each run must launch the kernels of its path, and the sums over
all runs are the ``launches`` of the kernels line. The last lines are a JSON
object of per-kernel results, the card's ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

CLIPS, FRAMES, H, W, S = 2, 25, 480, 854, 224
S8 = 448                            # ViT-S/8 input: 56x56 patches, 3,137 tokens


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "n/a"


def cuda_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Mean time of ``fn`` on the card (CUDA events over ``reps`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def trace(fn, label: str, reps: int = 3, top: int = 8) -> None:
    """Device idle share and kernel time by name over ``reps`` calls of
    ``fn`` under ``torch.profiler``. The window is a host range around the
    calls that ends in a synchronise; busy time is the union of the device
    events' intervals (kernels, copies, memsets) inside it. Only device
    events count: in ``key_averages`` a CPU op's row carries its kernels'
    device time as well, so summing all rows counts that time twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke.trace"):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    win = next(e for e in events if e.name() == "chip_smoke.trace"
               and e.device_type() == DeviceType.CPU)
    lo, hi = win.start_ns(), win.end_ns()
    spans, by_name = [], {}
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        a, b = max(e.start_ns(), lo), min(e.end_ns(), hi)
        if b > a:
            spans.append((a, b))
            n, t = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (n + 1, t + b - a)
    if not spans:
        raise AssertionError(f"trace {label}: no device event in the window")
    busy, end = 0, lo
    for a, b in sorted(spans):
        busy += max(0, b - max(a, end))
        end = max(end, b)
    wall = hi - lo
    print(f"trace {label}: {wall / reps / 1e6:.3f} ms per call under the "
          f"profiler, device busy {busy / reps / 1e6:.3f} ms, idle "
          f"{100 * (1 - busy / wall):.2f} %, {len(spans) / reps:.0f} device "
          f"events per call", flush=True)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {t / reps / 1e6:9.3f} ms {n / reps:5.0f}x  {name[:90]}", flush=True)


def synthetic_clips(seed: int = 0, textured: bool = False):
    """Two clips of a coloured box moving over a noisy background, with the
    box's annotation, made from ``seed``. ``textured``: the box carries a
    fixed random texture instead of one colour. On a one-colour box the
    patches of a random-init ViT-S/8 at 448 differ only through a faint
    position signal, which rounding the features to bf16 (the reference's
    own rounding point, before the propagation) erases; the propagated
    masks then differ between bf16 and f32 with no kernel involved (the
    plain versions on the host show the same gap). A textured box gives
    the top-k matches by content in both."""
    rng = np.random.default_rng(seed)
    clips = []
    for v in range(CLIPS):
        frames = rng.integers(0, 60, (FRAMES, H, W, 3), dtype=np.uint8)
        annots = np.zeros((FRAMES, H, W), np.uint8)
        color = rng.integers(120, 256, 3)
        if textured:
            color = rng.integers(100, 256, (160, 220, 3), dtype=np.uint8)
        for t in range(FRAMES):
            y, x = 100 + 4 * t + 20 * v, 200 + 9 * t
            frames[t, y:y + 160, x:x + 220] = color
            annots[t, y:y + 160, x:x + 220] = 1
        clips.append((frames, annots))
    return clips


def _tensor_maker(dev, rng):
    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    def w(n_in, n_out):
        return t(rng.standard_normal((n_in, n_out)) / np.sqrt(n_in))

    return t, w


def _reporter(results: dict):
    """``report(name, got, want, bound, ms, plain_ms)`` prints one check and
    keeps its numbers under ``key`` (default ``name``); the kernels line
    reads ``results[name]``."""

    def report(name, got, want, bound, ms, plain_ms, extra="", key=None):
        err = (got.float() - want.float()).abs().max().item()
        rel = ((got.float() - want.float()).abs()
               / want.float().abs().clamp(min=1e-6)).max().item()
        results[key or name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        print(f"kernel {key or name}: max_abs_err={err:.3e} max_rel_err={rel:.3e} "
              f"bound: {bound} {extra}| kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
              flush=True)

    return report


def lattice_features(rng, lead: tuple, D: int = 384, nnz: int = 256):
    """[*lead, D] f32 features with ``nnz`` entries of +-1/16 at random
    places and zeros elsewhere: unit norm exactly (the normalisation is
    exact), every dot product a multiple of 1/256, exact in f32 whatever
    the summation order."""
    n = int(np.prod(lead))
    x = np.zeros((n, D), np.float32)
    cols = np.argsort(rng.random((n, D)), axis=1)[:, :nnz]
    x[np.arange(n)[:, None], cols] = rng.choice(
        np.asarray([-1 / 16, 1 / 16], np.float32), (n, nnz))
    return x.reshape(*lead, D)


def check_propagation(dev, report, rng, N: int, key: str,
                      lattice: bool = False) -> None:
    """K3 on two 25-frame clips of N patches at D=384 (n_last 4, radius 12,
    top-k 5), inputs drawn from ``rng``; bound rtol=1e-4, atol=1e-5 (f32
    sums in another order) and argmax agreement >= 99.9 %.

    The bound holds only where no row's k-th and (k+1)-th affinities lie
    within f32 rounding of each other: there the kept set depends on the
    summation order, and the plain version in f32 and in f64 differ as
    much. Normal features at 150,000 rows (3,136 patches) draw such rows
    under every seed tried; ``lattice`` features (``lattice_features``)
    give exact dot products, so both versions order every row alike."""
    from timetuning_tpu_torch.ops import propagation_cuda as prc

    t, _ = _tensor_maker(dev, rng)
    feats = t(lattice_features(rng, (CLIPS, FRAMES, N)) if lattice else
              rng.standard_normal((CLIPS, FRAMES, N, 384)), torch.bfloat16)
    seg0 = torch.softmax(t(rng.standard_normal((CLIPS, 4, N))) * 3, dim=1)
    kw = dict(n_last=4, radius=12, topk=5)
    got = prc.propagate_labels_batch_cuda(feats, seg0, **kw)
    want = prc.propagate_labels_batch_plain(feats, seg0, **kw)
    torch.cuda.synchronize()
    close = torch.isclose(got, want, rtol=1e-4, atol=1e-5).float().mean().item()
    agree = (got.argmax(2) == want.argmax(2)).float().mean().item()
    report("propagation", got, want,
           "rtol=1e-4 atol=1e-5 (f32 sums in another order), argmax >= 99.9%",
           cuda_ms(lambda: prc.propagate_labels_batch_cuda(feats, seg0, **kw)),
           cuda_ms(lambda: prc.propagate_labels_batch_plain(feats, seg0, **kw),
                   warmup=1, reps=3 if N > 1000 else 5),
           extra=f"N={N}{' lattice' if lattice else ''} within_tol={close:.6f} "
                 f"argmax_agree={agree:.6f} ",
           key=key)
    if close < 1.0 or agree < 0.999:
        raise AssertionError(f"{key}: kernel disagrees with plain version")


def check_long_token_kernels(dev, results: dict) -> None:
    """The kernels of the ViT-S/8 at 448 path, at its shapes."""
    from timetuning_tpu_torch.ops import flash_attention as fa
    from timetuning_tpu_torch.ops import fused_block as fb

    rng = np.random.default_rng(8)
    t, w = _tensor_maker(dev, rng)
    report = _reporter(results)
    T8 = (S8 // 8) ** 2 + 1

    # flash: one block's attention core of 4 frames x 6 heads (the plain
    # version holds [4, 6, S, S] f32 scores, 236 MB a frame), in f32, at
    # queries != keys with a key mask, then in bf16 (the kernels line's)
    def check_flash(key, q, k, v, kv_len, atol, rtol, bound, extra):
        got = fa.flash_attention(q, k, v, kv_len=kv_len)
        want = fa.flash_attention_xla(q, k, v, kv_len=kv_len)
        torch.cuda.synchronize()
        ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
        report("flash_attention", got, want, bound,
               cuda_ms(lambda: fa.flash_attention(q, k, v, kv_len=kv_len)),
               cuda_ms(lambda: fa.flash_attention_xla(q, k, v, kv_len=kv_len),
                       warmup=1, reps=5),
               extra=extra, key=key)
        if not ok:
            raise AssertionError(f"{key}: kernel disagrees with plain version")

    qkv = [rng.standard_normal((4, 6, T8, 64)) for _ in range(3)]
    f32 = "atol=1e-5 rtol=1e-4 (f32 sums in another order)"
    q, k, v = (t(a) for a in qkv)
    check_flash("flash_attention/f32", q, k, v, None, 1e-5, 1e-4, f32,
                f"f32 [4x6, {T8}, 64] ")
    check_flash("flash_attention/masked", q[:, :, :1000], k, v, 2900, 1e-5, 1e-4,
                f32, f"f32 Sq=1000 Sk={T8} kv_len=2900 ")
    q, k, v = (t(a, torch.bfloat16) for a in qkv)
    check_flash("flash_attention", q, k, v, None, 4e-3, 1e-2,
                "atol=4e-3 rtol=1e-2 (one bf16 ulp of the output, p rounds "
                "to bf16 against another max)", f"bf16 [4x6, {T8}, 64] ")
    del q, k, v

    # the row kernels: one block's branches at 50 frames x 3,137 tokens;
    # bound: bf16 rounding at O(1) values
    D, Hd, B = 384, 1536, CLIPS * FRAMES
    x = t(rng.standard_normal((B, T8, D)), torch.bfloat16)
    y = t(rng.standard_normal((B, T8, D)), torch.bfloat16)
    ln_s, ln_b = t(1 + 0.1 * rng.standard_normal(D)), t(0.1 * rng.standard_normal(D))
    w_qkv, b_qkv = w(D, 3 * D), t(0.1 * rng.standard_normal(3 * D))
    w_proj, b_proj = w(D, D), t(0.1 * rng.standard_normal(D))
    mlp = (ln_s, ln_b, w(D, Hd), t(0.1 * rng.standard_normal(Hd)), w(Hd, D),
           t(0.1 * rng.standard_normal(D)))
    for name, kern, plain, args in (
            ("ln_dense", fb.ln_dense_rows, fb.ln_dense_xla,
             (x, ln_s, ln_b, w_qkv, b_qkv)),
            ("dense_residual", fb.dense_residual_rows, fb.dense_residual_xla,
             (y, x, w_proj, b_proj)),
            ("mlp_rows", fb.mlp_rows, fb.mlp_block_xla, (x, *mlp))):
        got = kern(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        ok = torch.allclose(got.float(), want.float(), atol=3e-2, rtol=3e-2)
        report(name, got, want, "atol=rtol=3e-2 (bf16 rounding at O(1))",
               cuda_ms(lambda: kern(*args)), cuda_ms(lambda: plain(*args)),
               extra=f"[{B}, {T8}, {D}] ")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with plain version")
        del got, want

    check_propagation(dev, report, np.random.default_rng(3136), (S8 // 8) ** 2,
                      "propagation/s8", lattice=True)


def check_kernels(dev, results: dict) -> None:
    from timetuning_tpu_torch.data.transforms import IMAGENET_MEAN, REFERENCE_STD
    from timetuning_tpu_torch.ops import fused_block as fb
    from timetuning_tpu_torch.ops import preprocess_cuda as pc

    rng = np.random.default_rng(0)
    t, w = _tensor_maker(dev, rng)
    D, Hd, heads, B, T = 384, 1536, 6, CLIPS * FRAMES, 197

    x = t(rng.standard_normal((B, T, D)), torch.bfloat16)
    ln_s = t(1 + 0.1 * rng.standard_normal(D))
    ln_b = t(0.1 * rng.standard_normal(D))
    attn = (ln_s, ln_b, w(D, 3 * D), t(0.1 * rng.standard_normal(3 * D)),
            w(D, D), t(0.1 * rng.standard_normal(D)))
    mlp = (ln_s, ln_b, w(D, Hd), t(0.1 * rng.standard_normal(Hd)), w(Hd, D),
           t(0.1 * rng.standard_normal(D)))

    report = _reporter(results)

    # K1, K2: one block's branch at B=50 frames x 197 tokens; bound: bf16
    # rounding at O(1) values (the kernel adds the residual in f32, the plain
    # composition in bf16: one bf16 ulp apart)
    for name, kern, plain, wts in (
            ("attention_block", fb.attention_block_branch,
             fb.attention_block_xla, attn + (heads,)),
            ("mlp_block", fb.mlp_block_branch, fb.mlp_block_xla, mlp)):
        got = kern(x, *wts)
        want = plain(x, *wts)
        torch.cuda.synchronize()
        ok = torch.allclose(got.float(), want.float(), atol=3e-2, rtol=3e-2)
        report(name, got, want, "atol=rtol=3e-2 (bf16 rounding at O(1))",
               cuda_ms(lambda: kern(x, *wts)), cuda_ms(lambda: plain(x, *wts)))
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with plain version")

    check_propagation(dev, report, rng, 196, "propagation")

    # K4: 50 frames of 480x854 uint8; bound: one bf16 ulp of the normalised
    # values (|x| < 4 -> 2^-6 = 1.6e-2), atol=2e-2
    frames = torch.from_numpy(
        rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)).to(dev)
    args = (S, IMAGENET_MEAN, REFERENCE_STD)
    got = pc.eval_preprocess_cuda(frames, *args)
    want = pc.eval_preprocess_plain(frames, *args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    ok = torch.allclose(got.float(), want, atol=2e-2, rtol=0)
    report("preprocess", got, want, "atol=2e-2 (one bf16 ulp below 4)",
           cuda_ms(lambda: pc.eval_preprocess_cuda(frames, *args)),
           cuda_ms(lambda: pc.eval_preprocess_plain(frames, *args)))
    if not ok:
        raise AssertionError("preprocess: kernel disagrees with plain version")


def check_vit(dev, arch: str, size: int, n: int) -> None:
    """12 blocks of ``arch`` through the kernels on the card against the
    plain bf16 forward (the same weights on the CPU), ``n`` frames at
    ``size``; bound: per-token cosine >= 0.999 (bf16 rounding accumulated
    over 12 blocks)."""
    from timetuning_tpu_torch.models.registry import get_backbone

    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (n, size, size, 3)).astype(np.float32))
    with torch.inference_mode():
        got = get_backbone(arch, dtype=torch.bfloat16, device=dev).module(
            x.to(dev))["tokens"].float().cpu()
        want = get_backbone(arch, dtype=torch.bfloat16).module(
            x)["tokens"].float()
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    print(f"{arch} at {size}, {got.shape[1]} tokens, 12 blocks (kernels on the "
          f"card vs plain bf16 on the host): min per-token cosine "
          f"{cos.min().item():.6f} (bound >= 0.999)", flush=True)
    if not torch.isfinite(got).all() or cos.min().item() < 0.999:
        raise AssertionError(f"{arch}: kernel forward disagrees with plain forward")


# the kernels each main-path run must launch
PATH_KERNELS = {
    ("dino-s16", "bfloat16"): ("attention_block", "mlp_block", "propagation",
                               "preprocess"),
    ("dino-s16", "float32"): ("propagation",),
    ("dino-s8", "bfloat16"): ("flash_attention", "ln_dense", "dense_residual",
                              "mlp_rows", "propagation", "preprocess"),
    ("dino-s8", "float32"): ("flash_attention", "propagation"),
    ("linear_probe", "float32"): ("flash_attention",),
}


def counted(path: tuple, fn, totals: dict):
    """Run ``fn`` with every launch count set to 0 just before and read just
    after; fail if a kernel of ``path`` was not launched; add the counts to
    ``totals``."""
    from timetuning_tpu_torch.ops import kernel_lib

    torch.cuda.synchronize()
    kernel_lib.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = kernel_lib.launch_counts()
    missing = [k for k in PATH_KERNELS[path] if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{path}: kernels not launched: {missing}")
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    return out, counts


def run_eval(dev, clips, arch: str, size: int, totals: dict) -> dict:
    """The port's propagation eval (``cli/propagate``'s per-group compute and
    scoring) on ``clips`` with ``arch`` at ``size``, in bf16 through the
    kernels and in f32; fails if |J&F(bf16) - J&F(f32)| > 0.05."""
    from timetuning_tpu_torch.cli import propagate as prop
    from timetuning_tpu_torch.models.registry import get_backbone

    n = CLIPS * FRAMES
    frames = torch.from_numpy(np.stack([f for f, _ in clips])).to(dev)
    scores = {}
    for dtype in ("bfloat16", "float32"):
        args = prop.build_parser().parse_args([
            "--architecture", arch, "--compute_dtype", dtype,
            "--input_resolution", str(size), "--n_last_frames", "4",
            "--size_mask_neighborhood", "12", "--topk", "5",
            "--clip_batch", str(CLIPS)])
        bb = get_backbone(args.architecture, dtype=prop.compute_dtype(args),
                          device=dev)
        prop.evaluate_clips(args, bb, clips[:1], dev)           # warm-up
        t0 = time.perf_counter()
        res, counts = counted((arch, dtype),
                              lambda: prop.evaluate_clips(args, bb, clips, dev),
                              totals)
        wall = time.perf_counter() - t0
        scores[dtype] = res["jf"]

        # the device compute of one group alone (K=4, as evaluate_clips
        # picks for one object)
        first = [prop.resize_nearest(torch.from_numpy(a[:1].astype(np.float32)),
                                     (size, size))[0].numpy().astype(np.int64)
                 for _, a in clips]
        onehots = torch.from_numpy(np.stack([
            prop.first_frame_onehot(f, bb.spatial_resolution(size), 4)
            for f in first])).to(dev)
        def group():
            return prop.propagate_clip_group(
                bb, frames, onehots, input_resolution=size, n_last=4,
                radius=12, topk=5, dtype=prop.compute_dtype(args))

        ms = cuda_ms(group, warmup=1, reps=5)
        s = scores[dtype]
        print(f"eval {arch}/{size} {dtype}: J={s['J']:.6f} F={s['F']:.6f} "
              f"J&F={s['J&F']:.6f} | evaluate_clips (with host J&F) "
              f"{wall * 1e3:.1f} ms = {n / wall:.1f} frames/s | device compute "
              f"{ms:.2f} ms per {CLIPS}-clip group = {n / ms * 1e3:.1f} frames/s "
              f"| launches {counts}", flush=True)
        trace(group, f"{arch}/{size} {dtype} group")
        del bb
    if not all(np.isfinite(v) for s in scores.values() for v in s.values()):
        raise AssertionError(f"{arch}: non-finite scores {scores}")
    delta = abs(scores["bfloat16"]["J&F"] - scores["float32"]["J&F"])
    if delta > 0.05:
        raise AssertionError(f"{arch}: |J&F(bf16) - J&F(f32)| = {delta} > 0.05")
    return scores


def synthetic_voc_batches(n_batches: int, seed: int = 2):
    """Pascal-VOC-layout batches as the loader yields them: uint8 images
    [2, 448, 448, 3] of a coloured box on noise, masks [2, 100, 100] with the
    box's class (1-20), background 0 and an ignored (255) border."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_batches):
        imgs = rng.integers(0, 60, (2, S8, S8, 3), dtype=np.uint8)
        masks = np.zeros((2, 100, 100), np.uint8)
        masks[:, :2] = masks[:, -2:] = 255
        for i in range(2):
            cls = int(rng.integers(1, 21))
            y, x = (int(v) for v in rng.integers(20, 200, 2))
            imgs[i, y:y + 200, x:x + 200] = rng.integers(120, 256, 3)
            masks[i, 2 + y * 100 // S8:(y + 200) * 100 // S8,
                  x * 100 // S8:(x + 200) * 100 // S8] = cls
        batches.append((imgs, masks))
    return batches


def run_linear_probe(dev, totals: dict) -> dict:
    """``cli/linear_probe``'s train and validate at dino-s8/448 in f32: two
    epochs of two SGD steps on in-memory batches, validation on a third."""
    from timetuning_tpu_torch.cli import linear_probe as lp
    from timetuning_tpu_torch.models.registry import get_backbone

    args = lp.build_parser().parse_args([
        "--pascal_root", "(in-memory batches)", "--architecture", "dino-s8",
        "--input_resolution", str(S8), "--batch_size", "2", "--num_epochs", "2"])
    bb = get_backbone(args.architecture, dtype=torch.float32, device=dev)
    batches = synthetic_voc_batches(3)
    lines = []

    def log(msg):
        lines.append(msg)
        print(f"linear probe dino-s8/{S8} f32: {msg}", flush=True)

    t0 = time.perf_counter()
    out, counts = counted(("linear_probe", "float32"),
                          lambda: lp.train_and_validate(args, bb, batches[:2],
                                                        batches[2:], dev, log),
                          totals)
    print(f"linear probe: {time.perf_counter() - t0:.2f} s for 4 steps and 2 "
          f"validations of 2 images | launches {counts}", flush=True)
    loss = float(lines[-1].split("loss=")[1].split()[0])
    if not (np.isfinite(loss) and all(np.isfinite(v) for v in out.values())
            and 0.0 <= out["best_miou"] <= 1.0):
        raise AssertionError(f"linear probe: non-finite loss or mIoU {lines}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test needs a CUDA card")
    from timetuning_tpu_torch.ops import kernel_lib

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}",
          flush=True)
    print(f"nvidia-smi name, power.limit: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    path = kernel_lib.build()
    kernel_lib.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {path.name}", flush=True)

    results: dict = {}
    check_kernels(dev, results)
    check_long_token_kernels(dev, results)
    check_vit(dev, "dino-s16", S, 4)
    check_vit(dev, "dino-s8", S8, 1)

    totals: dict = {}
    run_eval(dev, synthetic_clips(), "dino-s16", S, totals)
    run_eval(dev, synthetic_clips(textured=True), "dino-s8", S8, totals)
    run_linear_probe(dev, totals)

    missing = [k for k in kernel_lib.KERNELS if totals.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels launched by no main-path run: {missing}")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": totals[name], **results[name]}
        for name, k in kernel_lib.KERNELS.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
