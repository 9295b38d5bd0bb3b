#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card and ``nvcc``, and
imports nothing of JAX. Phases, each of which raises on failure (exit code
1, no result line):

1. environment: versions, the card's name and power limit; no CUDA -> fail;
2. build of the four hand-written kernels from ``timetuning_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the eval below (50 frames of ViT-S/16 at 224, two 25-frame clips of
   480x854), with its error bound and the times of both (CUDA events);
4. the DAVIS mask-propagation eval of the port (``cli/propagate``'s
   per-group compute) on two synthetic 25-frame 480x854 clips at full
   ViT-S/16 width (``dino-s16``, seeded random weights), in bf16 through
   the kernels and in f32; J&F of both, launch counts of the bf16 run.

The last lines are a JSON object of per-kernel results, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

CLIPS, FRAMES, H, W, S = 2, 25, 480, 854, 224


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


def synthetic_clips(seed: int = 0):
    """Two clips of a coloured box moving over a noisy background, with the
    box's annotation, made from ``seed``."""
    rng = np.random.default_rng(seed)
    clips = []
    for v in range(CLIPS):
        frames = rng.integers(0, 60, (FRAMES, H, W, 3), dtype=np.uint8)
        annots = np.zeros((FRAMES, H, W), np.uint8)
        color = rng.integers(120, 256, 3)
        for t in range(FRAMES):
            y, x = 100 + 4 * t + 20 * v, 200 + 9 * t
            frames[t, y:y + 160, x:x + 220] = color
            annots[t, y:y + 160, x:x + 220] = 1
        clips.append((frames, annots))
    return clips


def check_kernels(dev, results: dict) -> None:
    from timetuning_tpu_torch.data.transforms import IMAGENET_MEAN, REFERENCE_STD
    from timetuning_tpu_torch.ops import fused_block as fb
    from timetuning_tpu_torch.ops import preprocess_cuda as pc
    from timetuning_tpu_torch.ops import propagation_cuda as prc

    rng = np.random.default_rng(0)
    D, Hd, heads, B, T = 384, 1536, 6, CLIPS * FRAMES, 197

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    def w(n_in, n_out):
        return t(rng.standard_normal((n_in, n_out)) / np.sqrt(n_in))

    x = t(rng.standard_normal((B, T, D)), torch.bfloat16)
    ln_s = t(1 + 0.1 * rng.standard_normal(D))
    ln_b = t(0.1 * rng.standard_normal(D))
    attn = (ln_s, ln_b, w(D, 3 * D), t(0.1 * rng.standard_normal(3 * D)),
            w(D, D), t(0.1 * rng.standard_normal(D)))
    mlp = (ln_s, ln_b, w(D, Hd), t(0.1 * rng.standard_normal(Hd)), w(Hd, D),
           t(0.1 * rng.standard_normal(D)))

    def report(name, got, want, bound, ms, plain_ms, extra=""):
        err = (got.float() - want.float()).abs().max().item()
        rel = ((got.float() - want.float()).abs()
               / want.float().abs().clamp(min=1e-6)).max().item()
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        print(f"kernel {name}: max_abs_err={err:.3e} max_rel_err={rel:.3e} "
              f"bound: {bound} {extra}| kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
              flush=True)

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

    # K3: features of two 25-frame clips; bound rtol=1e-4, atol=1e-5 (f32
    # sums in another order) and argmax agreement >= 99.9 %
    feats = t(rng.standard_normal((CLIPS, FRAMES, 196, D)), torch.bfloat16)
    seg0 = torch.softmax(t(rng.standard_normal((CLIPS, 4, 196))) * 3, dim=1)
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
                   warmup=1, reps=5),
           extra=f"within_tol={close:.6f} argmax_agree={agree:.6f} ")
    if close < 1.0 or agree < 0.999:
        raise AssertionError("propagation: kernel disagrees with plain version")

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


def check_vit(dev) -> None:
    """12 blocks of ViT-S/16 through the kernels on the card against the
    plain bf16 forward (the same weights on the CPU), 4 frames; bound:
    per-token cosine >= 0.999 (bf16 rounding accumulated over 12 blocks)."""
    from timetuning_tpu_torch.models.registry import get_backbone

    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, S, S, 3)).astype(np.float32))
    with torch.inference_mode():
        got = get_backbone("dino-s16", dtype=torch.bfloat16, device=dev).module(
            x.to(dev))["tokens"].float().cpu()
        want = get_backbone("dino-s16", dtype=torch.bfloat16).module(
            x)["tokens"].float()
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    print(f"vit-s16 12 blocks (kernels on the card vs plain bf16 on the host): "
          f"min per-token cosine {cos.min().item():.6f} (bound >= 0.999)",
          flush=True)
    if not torch.isfinite(got).all() or cos.min().item() < 0.999:
        raise AssertionError("vit: kernel forward disagrees with plain forward")


def run_eval(dev, clips):
    """The port's propagation eval (``cli/propagate``'s per-group compute and
    scoring) on ``clips``, in bf16 through the kernels and in f32. Launch
    counts are reset just before each timed run and read just after."""
    from timetuning_tpu_torch.cli import propagate as prop
    from timetuning_tpu_torch.models.registry import get_backbone
    from timetuning_tpu_torch.ops import kernel_lib

    n = CLIPS * FRAMES
    frames = torch.from_numpy(np.stack([f for f, _ in clips])).to(dev)
    scores, counts = {}, {}
    for dtype in ("bfloat16", "float32"):
        args = prop.build_parser().parse_args([
            "--architecture", "dino-s16", "--compute_dtype", dtype,
            "--input_resolution", str(S), "--n_last_frames", "4",
            "--size_mask_neighborhood", "12", "--topk", "5",
            "--clip_batch", str(CLIPS)])
        bb = get_backbone(args.architecture, dtype=prop.compute_dtype(args),
                          device=dev)
        prop.evaluate_clips(args, bb, clips[:1], dev)           # warm-up
        torch.cuda.synchronize()
        kernel_lib.reset_launch_counts()
        t0 = time.perf_counter()
        scores[dtype] = prop.evaluate_clips(args, bb, clips, dev)["jf"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[dtype] = kernel_lib.launch_counts()

        # the device compute of one group alone (K=4, as evaluate_clips
        # picks for one object)
        first = [prop.resize_nearest(torch.from_numpy(a[:1].astype(np.float32)),
                                     (S, S))[0].numpy().astype(np.int64)
                 for _, a in clips]
        onehots = torch.from_numpy(np.stack([
            prop.first_frame_onehot(f, bb.spatial_resolution(S), 4)
            for f in first])).to(dev)
        ms = cuda_ms(lambda: prop.propagate_clip_group(
            bb, frames, onehots, input_resolution=S, n_last=4, radius=12,
            topk=5, dtype=prop.compute_dtype(args)), warmup=1, reps=5)
        s = scores[dtype]
        print(f"eval {dtype}: J={s['J']:.6f} F={s['F']:.6f} J&F={s['J&F']:.6f} "
              f"| evaluate_clips (with host J&F) {wall * 1e3:.1f} ms = "
              f"{n / wall:.1f} frames/s | device compute {ms:.2f} ms per "
              f"{CLIPS}-clip group = {n / ms * 1e3:.1f} frames/s | launches "
              f"{counts[dtype]}", flush=True)
    return scores, counts


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
    check_vit(dev)

    scores, counts = run_eval(dev, synthetic_clips())

    jf = [scores[d]["J&F"] for d in scores]
    if not all(np.isfinite(v) for s in scores.values() for v in s.values()):
        raise AssertionError(f"non-finite scores {scores}")
    if abs(jf[0] - jf[1]) > 0.05:
        raise AssertionError(f"|J&F(bf16) - J&F(f32)| > 0.05: {scores}")
    missing = [k for k, v in counts["bfloat16"].items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the bf16 run: {missing}")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": counts["bfloat16"][name],
         **results[name]}
        for name, k in kernel_lib.KERNELS.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
