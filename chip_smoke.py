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
   of 480x854; kernel 4 also to ViT-S/8's 448 and on the in-training eval's
   60 Pascal images already at 224, 224 -> 224), kernels 1 and 2 also at the
   train step's 128 frames, the eval's 60 and the 128-clip driver step's
   512, kernel 1 at 8 x 577 tokens (its core's two
   passes), kernel 7 also at kernel 1's
   9,850 rows; the bf16 hidden of kernels 2 and 9 against the plain hidden,
   and their two launches (fc1 + GELU, fc2) timed apart;
   the flash kernel in bf16 and f32 at [4 x 6 heads, 3,137
   tokens, 64], at queries != keys with a key mask, in bf16 at the eval
   group's own 50 frames and at the sp phase's 1,569 local queries against
   3,138 gathered keys (kv_len 3,137); the row kernels (ln_dense,
   dense_residual, mlp_rows) at 50 frames x 3,137 tokens and at the sp
   phase's 4 x 1,569 rows; the propagation kernel (kernel 3)
   in bf16 and f32 at 196 and at 56x56 patches, with the rows it sent to
   its exact dense pass and its scratch bytes; kernel 10 (whole-sequence attention) in bf16 and f32 at the
   train step's [128, 6, 197, 64] and at 256, 257 (both sides of its
   one-pass limit) and 1,024 tokens; after each attention row the count of
   the softmax's exponentials and the time they alone need; kernel 11
   (Sinkhorn) at [200, 6,272], [200, 25,088] and [200, 22,656] (a 32-clip
   step with its queue full) with and without a validity mask, through both
   entries (Q, and the step's scores), against the matvec form and the
   materialising loop, and on a Q with two all-zero rows and a masked-out
   column; kernel 3 at the train step's 32 clips x 4 frames x 200 label
   channels; the zoo's shapes: kernel 1 with twelve heads of 32 (MoCo-v3
   ViT-S/16) at 8 x 197 and 8 x 785 tokens (its core's two passes), with six
   heads of 64 at 8 x 785, kernels 1 and 2 at ViT-B's width (D 768, hidden
   3,072) on 50 frames, kernel 10 in bf16 with heads of 32 at 197 and 785
   tokens;
4. 12 blocks of ViT-S/16 at 224 (4 frames) and of ViT-S/8 at 448 (1 frame,
   3,137 tokens) through the kernels against the plain bf16 forward on the
   host;
5. the DAVIS mask-propagation eval of the port (``cli/propagate``'s
   per-group compute) on two synthetic 25-frame 480x854 clips with seeded
   random weights, at ``dino-s16``/224 and at ``dino-s8``/448 (a textured
   box at both, see ``synthetic_clips``), each in bf16
   through the kernels and in f32; J&F of both, device frames/s, and a
   ``torch.profiler`` trace of three groups: device idle share and kernel
   time by name;
6. the linear probe (``cli/linear_probe``'s train and validate) at
   ``dino-s8``/448 in f32, a few SGD steps on in-memory synthetic batches:
   its attention runs the flash kernel in f32; finite loss and mIoU;
7. the TimeT train step (``core/timet.make_train_step``) at ViT-S/16 224,
   head [1024, 1024, 512, 256], 200 prototypes, 32 clips of 4 frames, bf16,
   blocks 10 and 11 + head + prototypes trainable: 6 steps in the default
   configuration (kernels 1, 2, 3 on the no-grad passes, plain attention on
   the grad path, kernel 11 for the assignment) with its time, clips/s, peak
   memory, split and trace, a step at 128 clips, then 3 steps with
   ``attn_impl="pallas"`` (kernel 10 in
   every block of every pass, its backward through the autograd Function),
   held to the default configuration's first loss and update;
8. the step's own assignment (kernel 11) on its score matrix, against the
   matvec form and the materialising loop, and the kernel relaunched there;
9. one f32 step of the full model at 2 clips on the card (kernel 11's
   assignment) against the same step on the host (the matvec form);
10. the training driver (``core/train.run_training``) at the same width on
   a synthetic dataset registered with the real clip loader (the card's
   machine may lack cv2 and PIL): 2 epochs of 4 steps at 32 clips, a resume
   from the checkpoint for a third epoch, traced, and an epoch of 10 steps
   at 128 clips: clips/s through loader, copy, augmentation and step over
   the whole window of steady steps (with and without the epoch-top save)
   and the median ms a step, the saves' ms, peak memory, the device's idle
   share; the augmentation alone at 32
   and 128 clips (device ms, launches: equal); the bare step at both sizes;
11. the augmentation on the card against the host on the same draws; then
   ``graphs``: the port's programs run as CUDA graphs (``runtime.CapturedCall``,
   the counterpart of ``jax.jit``) against the same programs eager, bit for
   bit, with the kernel launches of a call equal: 6 flagship steps at 32
   clips (``make_full_step``: augmentation + step), default and with
   ``attn_impl="pallas"``, through the queue turning ready under schedules
   that move every step (every loss, then every parameter, teacher leaf,
   queue row and AdamW moment); the step at 32 and 128 clips and
   ``run_training`` at 32 clips each way (ms, host ms, idle share, peak
   memory, clips/s over the window). Phases 5 and 17 make the same
   comparison for the bf16 eval groups and their features (``graphs eval ...``)
   and for each serving program (``graphs export ...``, the symbolic one at
   64, 65 and 7), and phase 12 for the in-training eval's feature
   and diagnostics functions (``graphs eval driver ...``). Every main path
   runs graphed by default;
12. the in-training Pascal eval (``make_eval_feature_fn`` + ``Evaluator``)
   at ViT-S/16 224, eval resolution 112, 21 clusters, on 120 synthetic
   images in batches of 60, dataset-wise in memory and streaming: mIoU,
   ms, k-means ms; before it, at the batch of 60, the feature function
   (with and without the attention) and the diagnostics' scores function
   graphed against eager, and the feature function against the plain
   preprocess and the plain blocks;
13. the zoo: every name of ``models/registry`` at full width with seeded
   weights on the eval feature path (8 uint8 480x854 frames -> the
   preprocess -> the backbone at 224), in bf16 and f32: ms a frame and
   launches; ViTs (STEGO and MAE too) bf16 against the f32 plain forward
   (per-token cosine >= 0.999), CNNs f32 card against host;
14. CBFE (``cli/cbfe.run_cbfe`` at its defaults: dino-s16 at 448, k = 300
   at resolution 100, 21 eval clusters, f32) on a synthetic Pascal tree of
   128 trainaug and 64 val images through the real loader: the five
   numbers, each stage's ms, peak memory; before it the feature function
   card against host and the boundary F card against host;
15. ``cli/propagate --use_optical_flow`` on the two synthetic clips;
16. heads of 32: kernels 5/6 in bf16 and f32 at 4 frames x 12 heads, 1,025
   and 3,137 keys with a key mask, kernel 10 in f32 at 8 x 12 x 197 and
   785, each against its plain version with the library's time beside it;
   ``mocov3-s16`` at 576 px (1,297 tokens) through the registry, bf16
   against f32 (per-token cosine >= 0.999);
17. the serving export (``cli/export.main``): dino-s16 at 224, bf16, batch
   64 written to a temporary ``.pt2`` and loaded with ``load_exported``:
   export s, MB, the round trip against the live forward (<= 1e-3),
   frames/s of both, their host ms a call and traces, one call launching
   exactly the preprocess once and K1, K2 twelve times each; the
   symbolic-batch program called at 65 and 7; dino-s8 at 448, batch 4
   (K4, K7, K5/6, K8, K9). Before it, K1's host us a call through the
   direct wrapper, ``kernel_entry`` and the custom op;
18. ``cli/parity`` stages 1-4 on a made-up full-size dino-s16 TimeT.pth,
   the synthetic DAVIS tree of the two clips and a synthetic Pascal tree:
   every report row, stage 1 within its atols, the metrics in [0, 1];
19. ``dp``: data parallelism, 2 ranks over gloo in two processes that
   share the card (NCCL refuses two ranks on one device; they show
   agreement and the cost of the collectives, not the speed of two cards):
   which collectives gloo takes on CUDA tensors; the flagship step at 32
   clips a rank, default then ZeRO-1 (losses, ms a rank step, peak memory a
   rank, optimizer elements a rank, the all-reduces of one step timed, the
   replicated state bit-identical across the ranks, kernel 11's cross-rank
   form launched 11 times a step and neither the one-process form nor the
   matvec form at all); the cross-rank kernel 11 on the step's own scores
   [6,272, 200] a rank against the plain group form and, together, against
   the one-launch kernel 11 on the concatenated [12,544, 200]; 2 f32 steps
   at 2 x 4 clips against one process on the 8; ``run_training`` at 2 ranks
   for 2 epochs and a resume, clips/s over the window.
20. ``moe``: the MoE ViT-S/16 (every 2nd block a Switch MoE of 8 experts,
   capacity 1.25) sparse-upcycled from the seeded dense weights: the
   upcycled MoE branch equal to gate x dense MLP on kept tokens and 0 on
   dropped ones; a 64-frame forward in bf16 (K1 in all 12 blocks, K2 in the
   6 dense ones) against f32 on the tokens routed alike; 3 flagship steps
   at 32 clips with ``moe_aux_weight`` 0.01 (loss falls, ``moe_aux`` in [1,
   8], frozen leaves bit-identical, K1 14, K2 7, K3 1, K11 1 a step); the
   ``--moe_every_k 2 --moe_experts 8`` export and its round trip;
21. ``ep``: the same model on a dp 1 x ep 2 mesh of 2 gloo ranks sharing
   the card (4 of the 8 experts a rank): the feature forward, 3 bf16 steps
   at 8 clips and 2 f32 steps at 4, each against one process, replicated
   state bit-identical, the all-reduces of a step timed;
22. ``tp``: the flagship dense model on a dp 1 x tp 2 mesh (half of qkv,
   fc1, proj, fc2 a rank, plain attention), the same gates; a TP state's
   checkpoint loaded into one process against the gathered parameters;
   ``cli/train --multihost true --tensor_parallel 2`` for an epoch and a
   resumed one, then one process resuming its checkpoint;
23. ``sp`` and ``pp``: 2 gloo ranks sharing the card: ``dino-s8`` at 448,
   batch 4, on a dp 1 x sp 2 mesh (1,569 rows a slab: K7, K5/6 with local
   queries against the gathered keys, K8, K9, 12 each a rank) and
   ``dino-s16`` at 224, batch 64, on a dp 1 x pp 2 mesh at ``n_micro`` 2
   (auto) and 4 (K1, K2 6 a tick a stage), each in bf16 and f32 against the
   one-process forward (bf16 per-token cosine >= 0.999, f32 max |diff| <=
   1e-4 with TF32 off): ms a forward, the all-reduces of one by size, the
   parameter bytes a pipe rank holds;
24. ``export mesh``: the five multi-device ``cli/export`` programs (tp 2,
   ep 2 on the upcycled MoE, sp 2 at dino-s8 448 batch 4, pp 2, dp 2 at
   dino-s16 224 batch 64), each exported by 2 ranks (one program a rank
   and a manifest) and loaded by 2 fresh ranks: the round trip against the
   live mesh forward (<= 1e-3), the features against the one-device
   program's (bf16 per-token cosine >= 0.999), export s, MB a rank beside
   the one-device program's (tp and pp under it), frames/s of the program
   and of the live mesh forward, one call's launches a rank.

After phase 3 the kernels' backward (K1, K2 at 50 x 197; K7, K8, K9, K5/6
at 4 x 3,137) against autograd through the plain versions, and after
phase 7 the flagship step with ``grad_attn_impl=None`` (the block kernels
and their backward on the grad path: 16 launches of K1 and K2 a step,
first loss within 2e-3 of the default's) and the same step with
``ViTConfig.remat`` (the same loss, 18 launches, peak memory of both).

Beside each kernel's time the script prints the least time the card could
take for the same work (``bound_ms``: the larger of its bytes, each input
read and each output written once, over 3.35 TB/s, and its operations over
the published peak of their type, 989 TFLOP/s bf16 or 67 TFLOP/s f32) and,
where PyTorch has library calls for the same function, their time
(``library_ms``; measured here, used nowhere in the port). Kernel, plain and
library times are device times: the timed launches are queued behind a
device-side sleep, so a slow host does not show in them.

Launch counts are set to 0 just before each main-path run (phases 5 to 10,
12 to 18 and 20, and in each rank of phases 19 and 21 to 24)
and read just after; each run must launch the kernels of its path, and the
sums over all runs are the ``launches`` of the kernels line. The last lines
are a JSON object of per-kernel results, the card's ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

CLIPS, FRAMES, H, W, S = 2, 25, 480, 854, 224
S8 = 448                            # ViT-S/8 input: 56x56 patches, 3,137 tokens
TRAIN_B, TRAIN_F = 32, 4            # the train step's clips and frames a clip
EVAL_BATCH = 60                     # images a batch of the in-training Pascal eval
EVAL_GROUP = CLIPS * FRAMES         # frames of one propagation eval group
ZOO_FRAMES = 8                      # frames of the zoo's feature path a name
S8_NORMAL_SEED = 33                 # K3's normal features at 3,136 patches

# published dense peaks of one H100 SXM (NVIDIA's data sheet) at 700 W
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "tf32": 495e12}
MEM_BYTES_PER_S = 3.35e12


def io_bytes(*tensors) -> int:
    """Bytes of the tensors as they are passed: each read or written once."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(nbytes: float, flops: float, kind: str) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak of their type."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


@functools.lru_cache(maxsize=None)
def max_sm_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def exp_line(key: str, n_exp: float, bound_ms: float) -> None:
    """The exponentials a softmax over these scores needs and the time they
    alone take on the card's special-function units (16 a clock an SM, at
    the card's maximum SM clock), beside the row's ``bound_ms``."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = max_sm_mhz()
    ms = n_exp / (16 * sms * mhz * 1e6) * 1e3
    print(f"exponentials {key}: {n_exp:.4g} at 16 a clock an SM on {sms} SMs at "
          f"{mhz:.0f} MHz = {ms:.4f} ms alone (bound_ms {bound_ms:.4f})", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "n/a"


def cuda_ms(fn, warmup: int = 3, reps: int = 20, queued: bool = True) -> float:
    """Mean time of ``fn`` on the card (CUDA events over ``reps`` calls).
    ``queued``: the calls are queued behind a few milliseconds of device-side
    spinning, so a kernel of some ten microseconds is timed on the card and
    not by how fast the host enqueues it (a wrapper's Python and three
    tensor-map encodes take longer than such a kernel runs). The main-path
    phases pass False: there the host's share is part of what is measured."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(8_000_000)    # device clocks: ~4-5 ms
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class NoDeviceEvents(AssertionError):
    """A profiler trace with no device event inside its host window."""


def trace(fn, label: str, reps: int = 3, top: int = 8) -> dict:
    """Device idle share and kernel time by name over ``reps`` calls of
    ``fn`` under ``torch.profiler``. The window is a host range around the
    calls that ends in a synchronise; busy time is the union of the device
    events' intervals (kernels, copies, memsets) inside it. Only device
    events count: in ``key_averages`` a CPU op's row carries its kernels'
    device time as well, so summing all rows counts that time twice.
    Returns ``device_time``'s dict."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("chip_smoke.trace"):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        events = prof.profiler.kineto_results.events()
        win = next(e for e in events if e.name() == "chip_smoke.trace"
                   and e.device_type() == DeviceType.CPU)
        try:
            return device_time(events, win.start_ns(), win.end_ns(), reps, label, top)
        except NoDeviceEvents:
            if attempt:
                raise
            # a short window's device events have gone missing from a trace
            # once (the calls ran: their CUDA-event times were printed)
            print(f"trace {label}: the profiler kept no device event in its "
                  f"window; traced once more", flush=True)


def device_time(events, lo: int, hi: int, reps: int, label: str, top: int = 8) -> dict:
    """Print the device busy time, idle share and kernel time by name of the
    profiler ``events`` inside the host window [lo, hi] ns, per one of its
    ``reps`` calls; returns them (``busy_ms``, ``idle``, ``events``) per
    call."""
    from torch.autograd import DeviceType

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
        raise NoDeviceEvents(f"trace {label}: no device event in the window")
    busy, end = 0, lo
    for a, b in sorted(spans):
        busy += max(0, b - max(a, end))
        end = max(end, b)
    wall = hi - lo
    idle = 1 - busy / wall
    print(f"trace {label}: {wall / reps / 1e6:.3f} ms per call under the "
          f"profiler, device busy {busy / reps / 1e6:.3f} ms, idle "
          f"{100 * idle:.2f} %, {len(spans) / reps:.0f} device "
          f"events per call", flush=True)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {t / reps / 1e6:9.3f} ms {n / reps:5.0f}x  {name[:90]}", flush=True)
    return {"busy_ms": busy / reps / 1e6, "idle": idle, "events": len(spans) / reps}


def synthetic_clips(seed: int = 0, textured: bool = False):
    """Two clips of a coloured box moving over a noisy background, with the
    box's annotation, made from ``seed``. ``textured``: the box carries a
    fixed random texture instead of one colour. On a one-colour box the
    patches of a random-init ViT differ only through a faint position
    signal, which rounding the features to bf16 (the reference's own
    rounding point, before the propagation) erases; the propagated masks
    then differ between bf16 and f32 with no kernel involved (the plain
    versions on the host show the same gap), and move with any change of
    summation order: at ViT-S/16 the bf16 J&F went from 0.564 to 0.513
    against 0.558 in f32 when the block kernels changed their tile, the
    12-block forward agreeing with the plain one as before. A textured box
    gives the top-k matches by content in both (0.5495 against 0.5514 at
    ViT-S/16, 0.862 against 0.849 at ViT-S/8), so both evals use it."""
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
        """A Linear weight as ``models/vit.Block`` hands it to the kernels:
        the [out, in] f32 parameter transposed and cast to bf16, a [in, out]
        view that the wrappers read in place (no transpose-copy is timed)."""
        return t(rng.standard_normal((n_out, n_in)) / np.sqrt(n_in)).t().to(torch.bfloat16)

    return t, w


def _reporter(results: dict):
    """``report(name, got, want, tol, ms, plain_ms, work=..., library_ms=...)``
    prints one check and keeps its numbers under ``key`` (default ``name``);
    the kernels line reads ``results[name]``. ``work`` is (bytes, operations,
    "bf16" or "f32") of this call, for ``bound``."""

    def report(name, got, want, tol, ms, plain_ms, extra="", key=None, *, work,
               library_ms=None):
        err = (got.float() - want.float()).abs().max().item()
        rel = ((got.float() - want.float()).abs()
               / want.float().abs().clamp(min=1e-6)).max().item()
        b = bound(*work)
        results[key or name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                **b, "library_ms": library_ms}
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"kernel {key or name}: max_abs_err={err:.3e} max_rel_err={rel:.3e} "
              f"bound: {tol} {extra}| kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib}, least {b['bound_ms']:.4f} ms by {b['bound_by']}",
              flush=True)

    return report


def propagation_flops(B, T, N, D, K, n_last, radius, topk) -> float:
    """Operations K3's inputs need: the affinities of every target patch
    with the keys inside its window in each context frame (frame 0 and up
    to ``context_slots`` earlier ones), and the top-k entries of each row
    times the K label channels."""
    w = int(round(N ** 0.5))
    r = radius if radius > 0 else w
    per_axis = sum(min(i + r, w - 1) - max(i - r, 0) + 1 for i in range(w))
    n_slots = max(min(n_last, T - 2), 1)
    contexts = sum(1 + min(t - 1, n_slots) for t in range(1, T))
    return B * (contexts * per_axis ** 2 * 2 * D + (T - 1) * N * topk * K * 2)


def library_block(x, ln_s, ln_b, layers, residual=None, heads=0):
    """PyTorch's own calls for a block branch in bf16, the yardstick of the
    GEMM kernels: ``F.layer_norm``, then ``F.linear`` for each (weight
    [in, out], bias, gelu?) of ``layers``, with
    ``scaled_dot_product_attention`` after the first when ``heads`` is set,
    then the residual add. The port never calls this."""
    import torch.nn.functional as F

    wts = [(w.t().to(torch.bfloat16).contiguous(), b.to(torch.bfloat16), g)
           for w, b, g in layers]
    ln = None if ln_s is None else (ln_s.to(torch.bfloat16), ln_b.to(torch.bfloat16))

    def run():
        y = x if ln is None else F.layer_norm(x, x.shape[-1:], *ln, eps=1e-6)
        for i, (w, b, gelu) in enumerate(wts):
            y = F.linear(y, w, b)
            if gelu:
                y = F.gelu(y)
            if heads and i == 0:
                Bn, Sn, E = y.shape
                q, k, v = y.reshape(Bn, Sn, 3, heads, E // 3 // heads).permute(
                    2, 0, 3, 1, 4)
                y = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(
                    Bn, Sn, E // 3)
        return y if residual is None else residual + y

    return run


def check_mlp_parts(key: str, x, mlp) -> None:
    """The two launches of kernel 2 / 9 apart on ``x``: the bf16 hidden of the
    first (LN2 + fc1 + the kernels' one-range GELU) against the plain hidden
    (erf GELU) on the same bf16 weights, and both launches' device times
    under the profiler. The products are the same sums in another order and
    the two GELUs are 3e-7 apart, so a value differs where its rounding to
    bf16 flips, by one ulp; and where a normalised value of its row rounds
    the other way (the kernel's rsqrtf against rsqrt: a few rows in a
    hundred), which moves the row's pre-activations by that value's ulp
    times its weight. Bound: every hidden value within one bf16 ulp of the
    plain one or two such flips of the largest normalised value under the
    largest weight, at most 1e-3 of them differing at all."""
    from timetuning_tpu_torch.ops import fused_block as fb

    def ulp_of(a):
        return torch.exp2(torch.floor(torch.log2(a)) - 7)

    got = fb.mlp_hidden_rows(x, *mlp[:4]).float()
    want = fb.mlp_hidden_xla(x, *mlp[:4]).float()
    torch.cuda.synchronize()
    flips = (2 * ulp_of(fb._ln(x, mlp[0], mlp[1]).float().abs().max())
             * mlp[2].float().abs().max()).item()
    apart = (got - want).abs()
    over = (apart > ulp_of(torch.maximum(got.abs(), want.abs())).clamp(min=flips)).sum().item()
    share = (apart > 0).float().mean().item()
    print(f"hidden {key}: {list(got.shape)} bf16 against the plain hidden: "
          f"max_abs_err={apart.max().item():.3e}, over one ulp and {flips:.1e}: {over}, "
          f"differing at all: {share:.3e} (bound: 0 over, <= 1e-3 differing)",
          flush=True)
    if over or share > 1e-3:
        raise AssertionError(f"{key}: the kernel's hidden disagrees with the plain hidden")
    del got, want, apart
    trace(lambda: fb.mlp_rows(x, *mlp), f"{key}, fc1 and fc2 apart", reps=5, top=2)


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


def propagation_features(rng, kind: str, lead: tuple, D: int = 384):
    """K3's test features: ``normal``; ``lattice`` (``lattice_features``);
    ``ties``, every patch one of three lattice vectors, so that whole
    windows tie at the k-th value and every row takes the exact dense
    pass."""
    if kind == "normal":
        return rng.standard_normal((*lead, D))
    if kind == "lattice":
        return lattice_features(rng, lead, D)
    return lattice_features(rng, (3,), D)[rng.integers(0, 3, lead)]


def check_propagation(dev, report, rng, N: int, key: str, features: str = "normal",
                      shape: tuple = (CLIPS, FRAMES, 4),
                      kw: dict = dict(n_last=4, radius=12, topk=5),
                      dtype: torch.dtype = torch.bfloat16) -> None:
    """K3 on ``shape`` = (clips, frames, label channels) of N patches at
    D=384 (the evals': two 25-frame clips, n_last 4, radius 12, top-k 5),
    ``features`` (``propagation_features``) drawn from ``rng`` in ``dtype``;
    bound rtol=1e-4, atol=1e-5 (f32 sums in another order; f32 inputs
    through their TF32 split, hi.hi + hi.lo + lo.hi) and argmax agreement
    >= 99.9 %. The work is tagged by the type the products take: bf16
    inputs at the bf16 peak, f32 at the f32 one, with the least time of the
    design's own arithmetic beside it (three TF32 products at the TF32
    peak). Prints the rows that went through the exact dense pass (kept
    sets that do not fit a compact row) and the kernel's scratch bytes.

    The bound holds only where no row's k-th and (k+1)-th affinities lie
    within f32 rounding of each other: there the kept set depends on the
    summation order, and the plain version in f32 and in f64 differ as
    much. ``lattice`` features give exact dot products, so both versions
    order every row alike; ``normal`` ones at 3,136 patches are drawn from
    a seed whose rows keep their k-th and (k+1)-th dot products apart (by
    1.9e-7 at least, in f64: ``tools/propagation_gaps.py``), and the plain
    version in f64 is printed beside."""
    from timetuning_tpu_torch.ops import propagation_cuda as prc

    t, _ = _tensor_maker(dev, rng)
    B, T, K = shape
    feats = t(propagation_features(rng, features, (B, T, N)), dtype)
    seg0 = torch.softmax(t(rng.standard_normal((B, K, N))) * 3, dim=1)
    got, overflow, scratch = prc.propagate_labels_batch_stats(feats, seg0, **kw)
    want = prc.propagate_labels_batch_plain(feats, seg0, **kw)
    close = torch.isclose(got, want, rtol=1e-4, atol=1e-5).float().mean().item()
    agree = (got.argmax(2) == want.argmax(2)).float().mean().item()
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    flops = propagation_flops(B, T, N, 384, K, kw["n_last"], kw["radius"], kw["topk"])
    extra = ""
    if kind == "f32":
        split = bound(io_bytes(feats, seg0, got), 3 * flops, "tf32")["bound_ms"]
        extra = f"3xTF32 least {split:.4f} ms "
        if features == "normal":
            want64 = prc.propagate_labels_batch_plain(feats.double(), seg0.double(), **kw)
            near = [torch.isclose(x.double(), want64, rtol=1e-4, atol=1e-5).double().mean().item()
                    for x in (got, want)]
            extra += (f"within_tol against plain f64: kernel {near[0]:.6f} plain f32 "
                      f"{near[1]:.6f} ")
            del want64
    report("propagation", got, want,
           "rtol=1e-4 atol=1e-5 (f32 sums in another order), argmax >= 99.9%",
           cuda_ms(lambda: prc.propagate_labels_batch_cuda(feats, seg0, **kw)),
           cuda_ms(lambda: prc.propagate_labels_batch_plain(feats, seg0, **kw),
                   warmup=1, reps=3 if N > 1000 else 5),
           extra=f"{kind} [{B}, {T}, {N}, 384] x {K} channels {features} "
                 f"within_tol={close:.6f} argmax_agree={agree:.6f} overflow_rows="
                 f"{int(overflow.sum())} of {B * (T - 1) * N} scratch_bytes={scratch} "
                 + extra,
           key=key, work=(io_bytes(feats, seg0, got), flops, kind))
    if close < 1.0 or agree < 0.999:
        raise AssertionError(f"{key}: kernel disagrees with plain version")


@contextlib.contextmanager
def dense_pass_rows():
    """While open, K3's calls go through ``propagate_labels_batch_stats``;
    yields a list that gets each call's (rows through the exact dense pass,
    as a device tensor; rows; scratch bytes)."""
    from timetuning_tpu_torch.ops import propagation_cuda as prc

    calls = []
    entry = prc.propagate_labels_batch_cuda

    def recording(features, first_seg, **kw):
        out, overflow, scratch = prc.propagate_labels_batch_stats(features, first_seg, **kw)
        B, T, N, _ = features.shape
        calls.append((overflow.sum(), B * (T - 1) * N, scratch))
        return out

    prc.propagate_labels_batch_cuda = recording
    try:
        yield calls
    finally:
        prc.propagate_labels_batch_cuda = entry


def dense_pass_line(label: str, calls: list) -> None:
    rows = sum(n for _, n, _ in calls)
    over = sum(int(o) for o, _, _ in calls)
    scratch = max((b for _, _, b in calls), default=0)
    print(f"K3 {label}: {len(calls)} calls, {over} of {rows} rows through the exact "
          f"dense pass, scratch {scratch} bytes a call", flush=True)


def check_flash_kernels(dev, results: dict) -> None:
    """Kernels 5/6 at the ViT-S/8 448 path's shapes: one block's attention
    core of 4 frames x 6 heads (the plain version holds [4, 6, S, S] f32
    scores, 236 MB a frame), in f32, at queries != keys with a key mask,
    then in bf16 (the kernels line's), and in bf16 at the eval group's own
    50 frames (the plain version in chunks of 5 frames)."""
    from timetuning_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(8)
    t, _ = _tensor_maker(dev, rng)
    report = _reporter(results)
    T8 = (S8 // 8) ** 2 + 1
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def check_flash(key, q, k, v, kv_len, atol, rtol, tol, extra, chunk=None):
        chunk = chunk or q.shape[0]

        def plain():
            return torch.cat([fa.flash_attention_xla(q[i:i + chunk], k[i:i + chunk],
                                                     v[i:i + chunk], kv_len=kv_len)
                              for i in range(0, q.shape[0], chunk)])

        got = fa.flash_attention(q, k, v, kv_len=kv_len)
        want = plain()
        torch.cuda.synchronize()
        ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
        keys = k.shape[2] if kv_len is None else kv_len
        kind = "bf16" if q.dtype == torch.bfloat16 else "f32"
        n_exp = float(q.shape[0] * q.shape[1] * q.shape[2] * keys)
        # the library call on the same q and the unmasked keys
        report("flash_attention", got, want, tol,
               cuda_ms(lambda: fa.flash_attention(q, k, v, kv_len=kv_len)),
               cuda_ms(plain, warmup=1, reps=5 if chunk == q.shape[0] else 2),
               extra=extra, key=key,
               work=(io_bytes(q, k[:, :, :keys], v[:, :, :keys], got),
                     4.0 * n_exp * 64, kind),
               library_ms=cuda_ms(lambda: sdpa(q, k[:, :, :keys], v[:, :, :keys])))
        exp_line(key, n_exp, results[key]["bound_ms"])
        if not ok:
            raise AssertionError(f"{key}: kernel disagrees with plain version")

    qkv = [rng.standard_normal((4, 6, T8, 64)) for _ in range(3)]
    f32 = "atol=1e-5 rtol=1e-4 (f32 sums in another order)"
    bf16 = ("atol=4e-3 rtol=1e-2 (one bf16 ulp of the output, p rounds to bf16 "
            "against another max)")
    q, k, v = (t(a) for a in qkv)
    check_flash("flash_attention/f32", q, k, v, None, 1e-5, 1e-4, f32,
                f"f32 [4x6, {T8}, 64] ")
    check_flash("flash_attention/masked", q[:, :, :1000], k, v, 2900, 1e-5, 1e-4,
                f32, f"f32 Sq=1000 Sk={T8} kv_len=2900 ")
    q, k, v = (t(a, torch.bfloat16) for a in qkv)
    check_flash("flash_attention", q, k, v, None, 4e-3, 1e-2, bf16,
                f"bf16 [4x6, {T8}, 64] ")
    # the eval group's own launch: the strided q, k, v views of 50 frames' qkv rows
    B = CLIPS * FRAMES
    qkv50 = torch.from_numpy(rng.standard_normal((B, T8, 3, 6, 64), dtype=np.float32)
                             ).to(dev, torch.bfloat16)
    q, k, v = (qkv50[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    check_flash(f"flash_attention/bf16/{B}", q, k, v, None, 4e-3, 1e-2, bf16,
                f"bf16 [{B}x6, {T8}, 64] strided views, plain in chunks of 5 ", chunk=5)
    # the sp phase's launch: a slab's local queries (views of its qkv rows)
    # against the keys and values gathered over 2 ranks (views of the
    # gathered [4, 3,138, 2, 6, 64] buffer), the padded key masked
    rng = np.random.default_rng(1569)
    Sl = -(-T8 // MESH_WORLD)
    slab = torch.from_numpy(rng.standard_normal((SP_BATCH, Sl, 3, 6, 64), dtype=np.float32)
                            ).to(dev, torch.bfloat16)
    kv = torch.from_numpy(rng.standard_normal((SP_BATCH, Sl * MESH_WORLD, 2, 6, 64),
                                              dtype=np.float32)).to(dev, torch.bfloat16)
    q = slab[:, :, 0].permute(0, 2, 1, 3)
    k, v = (kv[:, :, i].permute(0, 2, 1, 3) for i in range(2))
    check_flash("flash_attention/sp", q, k, v, T8, 4e-3, 1e-2, bf16,
                f"bf16 [{SP_BATCH}x6] Sq={Sl} Sk={Sl * MESH_WORLD} kv_len={T8} strided views ")


def check_row_kernels(dev, report, rng, B: int, T: int, suffix: str = ""):
    """The row kernels (K7 ``ln_dense``, K8 ``dense_residual``, K9
    ``mlp_rows``) on one block's branches at [B, T, 384] against their plain
    versions, the library composition beside them; bound: bf16 rounding at
    O(1) values. Returns the MLP's input and weights."""
    from timetuning_tpu_torch.ops import fused_block as fb

    t, w = _tensor_maker(dev, rng)
    D, Hd = 384, 1536
    x = t(rng.standard_normal((B, T, D)), torch.bfloat16)
    y = t(rng.standard_normal((B, T, D)), torch.bfloat16)
    ln_s, ln_b = t(1 + 0.1 * rng.standard_normal(D)), t(0.1 * rng.standard_normal(D))
    w_qkv, b_qkv = w(D, 3 * D), t(0.1 * rng.standard_normal(3 * D))
    w_proj, b_proj = w(D, D), t(0.1 * rng.standard_normal(D))
    mlp = (ln_s, ln_b, w(D, Hd), t(0.1 * rng.standard_normal(Hd)), w(Hd, D),
           t(0.1 * rng.standard_normal(D)))
    M = B * T
    for name, kern, plain, args, flops, lib in (
            ("ln_dense", fb.ln_dense_rows, fb.ln_dense_xla,
             (x, ln_s, ln_b, w_qkv, b_qkv), 2.0 * M * D * 3 * D,
             library_block(x, ln_s, ln_b, [(w_qkv, b_qkv, False)])),
            ("dense_residual", fb.dense_residual_rows, fb.dense_residual_xla,
             (y, x, w_proj, b_proj), 2.0 * M * D * D,
             library_block(y, None, None, [(w_proj, b_proj, False)], residual=x)),
            ("mlp_rows", fb.mlp_rows, fb.mlp_block_xla, (x, *mlp),
             4.0 * M * D * Hd,
             library_block(x, ln_s, ln_b, [(mlp[2], mlp[3], True),
                                           (mlp[4], mlp[5], False)], residual=x))):
        got = kern(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        ok = torch.allclose(got.float(), want.float(), atol=3e-2, rtol=3e-2)
        report(name, got, want, "atol=rtol=3e-2 (bf16 rounding at O(1))",
               cuda_ms(lambda: kern(*args)), cuda_ms(lambda: plain(*args)),
               extra=f"[{B}, {T}, {D}] ", key=name + suffix,
               work=(io_bytes(*args, got), flops, "bf16"),
               library_ms=cuda_ms(lib))
        if not ok:
            raise AssertionError(f"{name + suffix}: kernel disagrees with plain version")
        del got, want
    return x, mlp


def check_long_token_kernels(dev, results: dict) -> None:
    """The row kernels and the propagation kernel of the ViT-S/8 at 448
    path, at its shapes (the row kernels at 50 frames x 3,137 tokens, and at
    the sp phase's slab, 4 frames x 1,569 rows)."""
    report = _reporter(results)
    T8 = (S8 // 8) ** 2 + 1
    x, mlp = check_row_kernels(dev, report, np.random.default_rng(8), CLIPS * FRAMES, T8)
    check_mlp_parts("mlp_rows", x, mlp)

    check_propagation(dev, report, np.random.default_rng(3136), (S8 // 8) ** 2,
                      "propagation/s8", "lattice")
    check_propagation(dev, report, np.random.default_rng(3136), (S8 // 8) ** 2,
                      "propagation/s8/f32", "lattice", dtype=torch.float32)
    # the TF32 split's lo products, its slack and its recomputed band at
    # work: normal f32 features; then the exact dense pass on every row
    check_propagation(dev, report, np.random.default_rng(S8_NORMAL_SEED),
                      (S8 // 8) ** 2, "propagation/s8/f32/normal", "normal",
                      dtype=torch.float32)
    check_propagation(dev, report, np.random.default_rng(3), (S8 // 8) ** 2,
                      "propagation/s8/ties", "ties")
    check_row_kernels(dev, report, np.random.default_rng(1569), SP_BATCH,
                      -(-T8 // MESH_WORLD), "/sp")


def check_block_kernel(report, name, key, kern, plain, x, wts, flops, lib) -> None:
    """A block kernel (K1, K2, K7) on ``x`` and its weights against its plain
    version, timed beside the library composition ``lib``; bound: bf16
    rounding at O(1) values (the kernel adds the residual in f32, the plain
    composition in bf16: one bf16 ulp apart)."""
    got = kern(x, *wts)
    want = plain(x, *wts)
    torch.cuda.synchronize()
    ok = torch.allclose(got.float(), want.float(), atol=3e-2, rtol=3e-2)
    report(name, got, want, "atol=rtol=3e-2 (bf16 rounding at O(1))",
           cuda_ms(lambda: kern(x, *wts)), cuda_ms(lambda: plain(x, *wts)),
           extra=f"{list(x.shape)} ", key=key,
           work=(io_bytes(x, *(a for a in wts if torch.is_tensor(a)), got),
                 flops, "bf16"),
           library_ms=cuda_ms(lib))
    if not ok:
        raise AssertionError(f"{key}: kernel disagrees with plain version")


def check_kernels(dev, results: dict) -> None:
    from timetuning_tpu_torch.data.transforms import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        REFERENCE_STD,
    )
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
    check_block = functools.partial(check_block_kernel, report)

    # K1, K2: one block's branch at B=50 frames x 197 tokens; bound: bf16
    # rounding at O(1) values (the kernel adds the residual in f32, the plain
    # composition in bf16: one bf16 ulp apart). K1 and K2 also at the train
    # step's 128 frames, K1 at a two-pass length of its core (8 x 577 tokens,
    # ViT-S/16 at 384); K7 at K1's own rows (9,850: 77 row blocks on the card's
    # SMs); K2's bf16 hidden against the plain hidden, its two launches apart
    def attn_flops(b, s):
        return 2.0 * b * s * D * 4 * D + 4.0 * b * heads * s * s * 64

    def attn_lib(xb):
        return library_block(xb, ln_s, ln_b, [(attn[2], attn[3], False),
                                              (attn[4], attn[5], False)],
                             residual=xb, heads=heads)

    M = B * T
    check_block("attention_block", "attention_block", fb.attention_block_branch,
                fb.attention_block_xla, x, attn + (heads,), attn_flops(B, T), attn_lib(x))
    check_block("mlp_block", "mlp_block", fb.mlp_block_branch, fb.mlp_block_xla, x, mlp,
                4.0 * M * D * Hd,
                library_block(x, ln_s, ln_b, [(mlp[2], mlp[3], True),
                                              (mlp[4], mlp[5], False)], residual=x))
    check_mlp_parts("mlp_block", x, mlp)
    check_block("ln_dense", f"ln_dense/{M}", fb.ln_dense_rows, fb.ln_dense_xla, x,
                attn[:4], 2.0 * M * D * 3 * D,
                library_block(x, ln_s, ln_b, [(attn[2], attn[3], False)]))
    more = np.random.default_rng(1)     # `rng` goes on to K3's features as it was
    # K1, K2 also at the in-training eval's batch of 60 frames and the
    # 128-clip driver step's 512
    for b, s in ((TRAIN_B * TRAIN_F, T), (8, 577), (EVAL_BATCH, T),
                 (4 * TRAIN_B * TRAIN_F, T)):
        xb = t(more.standard_normal((b, s, D)), torch.bfloat16)
        check_block("attention_block", f"attention_block/{b}x{s}",
                    fb.attention_block_branch, fb.attention_block_xla, xb,
                    attn + (heads,), attn_flops(b, s), attn_lib(xb))
        if s == T:
            check_block("mlp_block", f"mlp_block/{b}x{s}", fb.mlp_block_branch,
                        fb.mlp_block_xla, xb, mlp, 4.0 * b * s * D * Hd,
                        library_block(xb, ln_s, ln_b, [(mlp[2], mlp[3], True),
                                                       (mlp[4], mlp[5], False)],
                                      residual=xb))
            check_mlp_parts(f"mlp_block/{b}x{s}", xb, mlp)
        del xb

    check_propagation(dev, report, rng, 196, "propagation")
    check_propagation(dev, report, np.random.default_rng(196), 196, "propagation/f32",
                      dtype=torch.float32)

    # K4: 50 frames of 480x854 uint8 to the S/16 eval's 224 and the S/8
    # eval's 448, with the kernel's band plan; bound: one bf16 ulp of the
    # normalised values (|x| < 4 -> 2^-6 = 1.6e-2), atol=2e-2
    frames = torch.from_numpy(
        rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)).to(dev)
    for size in (S, S8):
        args = (size, IMAGENET_MEAN, REFERENCE_STD)
        got = pc.eval_preprocess_cuda(frames, *args)
        want = pc.eval_preprocess_plain(frames, *args, out_dtype=torch.float32)
        torch.cuda.synchronize()
        ok = torch.allclose(got.float(), want, atol=2e-2, rtol=0)
        plan = pc.band_plan(H, W, size, B, torch.cuda.get_device_properties(
            0).multi_processor_count)
        # the separable resize's multiply-adds, the cheaper order (W first)
        report("preprocess", got, want, "atol=2e-2 (one bf16 ulp below 4)",
               cuda_ms(lambda: pc.eval_preprocess_cuda(frames, *args)),
               cuda_ms(lambda: pc.eval_preprocess_plain(frames, *args)),
               extra=f"[{B}, {H}, {W}, 3] u8 -> {size}, bands of {plan.rows} rows, "
                     f"{B * plan.bands} blocks, {plan.blocks_per_sm} an SM ",
               key="preprocess" if size == S else f"preprocess/{size}",
               work=(io_bytes(frames, got),
                     2.0 * B * 3 * (H * size * plan.w_taps + size * size * plan.h_taps),
                     "f32"))
        if not ok:
            raise AssertionError(f"preprocess at {size}: kernel disagrees with plain version")
        del got, want

    # K4 at the in-training eval's batch: 60 Pascal images already at 224
    # (data/pascal.py resizes them to the input resolution), so a 224 -> 224
    # pass at scale 1 with the eval's std; same bound
    pascal = torch.from_numpy(
        rng.integers(0, 256, (EVAL_BATCH, S, S, 3), dtype=np.uint8)).to(dev)
    args = (S, IMAGENET_MEAN, IMAGENET_STD)
    got = pc.eval_preprocess_cuda(pascal, *args)
    want = pc.eval_preprocess_plain(pascal, *args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    ok = torch.allclose(got.float(), want, atol=2e-2, rtol=0)
    plan = pc.band_plan(S, S, S, EVAL_BATCH,
                        torch.cuda.get_device_properties(0).multi_processor_count)
    report("preprocess", got, want, "atol=2e-2 (one bf16 ulp below 4)",
           cuda_ms(lambda: pc.eval_preprocess_cuda(pascal, *args)),
           cuda_ms(lambda: pc.eval_preprocess_plain(pascal, *args)),
           extra=f"[{EVAL_BATCH}, {S}, {S}, 3] u8 -> {S} (the in-training eval's), "
                 f"bands of {plan.rows} rows, {EVAL_BATCH * plan.bands} blocks ",
           key=f"preprocess/{S}from{S}",
           work=(io_bytes(pascal, got),
                 2.0 * EVAL_BATCH * 3 * (S * S * plan.w_taps + S * S * plan.h_taps),
                 "f32"))
    if not ok:
        raise AssertionError("preprocess at 224 -> 224: kernel disagrees with plain version")


def check_mha_kernels(dev, results: dict) -> None:
    """Kernel 10 on the strided q, k, v views that models/vit.Attention makes
    of its qkv rows: the trunk's launch of a 32-clip step (one pass over a
    strip of 208 keys), both sides of the one-pass limit (256 and 257
    tokens) and the longest sequence the kernel takes (two passes)."""
    from timetuning_tpu_torch.ops import attention as at

    rng = np.random.default_rng(10)
    t, _ = _tensor_maker(dev, rng)
    report = _reporter(results)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    tols = {torch.bfloat16: (4e-3, 1e-2, "atol=4e-3 rtol=1e-2 (one bf16 ulp of "
                             "the output, a p that rounds the other way)"),
            torch.float32: (1e-5, 1e-4, "atol=1e-5 rtol=1e-4 (f32 sums in "
                            "another order)")}
    for B, S_tok, dtypes in ((TRAIN_B * TRAIN_F, 197, (torch.bfloat16, torch.float32)),
                             (8, 256, (torch.bfloat16, torch.float32)),
                             (8, 257, (torch.bfloat16,)),
                             (8, 1024, (torch.bfloat16, torch.float32))):
        base = rng.standard_normal((B, S_tok, 3, 6, 64))
        for dtype in dtypes:
            qkv = t(base, dtype)
            q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
            got = at.attention_mha(q, k, v)
            want = at.attention_mha_plain(q, k, v)
            torch.cuda.synchronize()
            atol, rtol, tol = tols[dtype]
            ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
            kind = "bf16" if dtype == torch.bfloat16 else "f32"
            key = "mha" if (S_tok, kind) == (197, "bf16") else f"mha/{kind}/{S_tok}"
            n_exp = float(B * 6 * S_tok * S_tok)
            plan = f"plan {at.mha_plan(S_tok)} " if kind == "bf16" else ""
            report("mha", got, want, tol,
                   cuda_ms(lambda: at.attention_mha(q, k, v)),
                   cuda_ms(lambda: at.attention_mha_plain(q, k, v), warmup=1, reps=5),
                   extra=f"{kind} [{B} x 6, {S_tok}, 64] {plan}", key=key,
                   work=(io_bytes(q, k, v, got), 4.0 * n_exp * 64, kind),
                   library_ms=cuda_ms(lambda: sdpa(q, k, v)))
            exp_line(key, n_exp, results[key]["bound_ms"])
            if not ok:
                raise AssertionError(f"{key}: kernel disagrees with plain version")
        del qkv, q, k, v, got, want


def check_zoo_kernels(dev, results: dict) -> None:
    """The block kernels at the zoo's new shapes: K1 with twelve heads of 32
    (MoCo-v3 ViT-S/16) at 197 tokens and at 785 (its core's two passes:
    ViT-S/8 at 224, STEGO, or any S/16 at 448), K1 at 785 with six heads of
    64, K1 and K2 at ViT-B's width (D 768, 12 heads, hidden 3,072: dino-b16,
    vit, mocov3-b16) on the eval group's 50 frames; K10 bf16 on the strided
    views of a qkv buffer with heads of 32 at 197 and 785 tokens. Inputs
    from a generator of their own."""
    from timetuning_tpu_torch.ops import attention as at
    from timetuning_tpu_torch.ops import fused_block as fb

    rng = np.random.default_rng(32)
    t, w = _tensor_maker(dev, rng)
    report = _reporter(results)

    def branches(D, hidden):
        ln_s, ln_b = t(1 + 0.1 * rng.standard_normal(D)), t(0.1 * rng.standard_normal(D))
        attn = (ln_s, ln_b, w(D, 3 * D), t(0.1 * rng.standard_normal(3 * D)),
                w(D, D), t(0.1 * rng.standard_normal(D)))
        mlp = (ln_s, ln_b, w(D, hidden), t(0.1 * rng.standard_normal(hidden)),
               w(hidden, D), t(0.1 * rng.standard_normal(D)))
        return attn, mlp

    def attn_lib(xb, attn, heads):
        return library_block(xb, attn[0], attn[1], [(attn[2], attn[3], False),
                                                    (attn[4], attn[5], False)],
                             residual=xb, heads=heads)

    for D, hidden, shapes in ((384, 1536, ((8, 197, 12), (8, 785, 12), (8, 785, 6))),
                              (768, 3072, ((EVAL_GROUP, 197, 12),))):
        attn, mlp = branches(D, hidden)
        for b, s_tok, heads in shapes:
            xb = t(rng.standard_normal((b, s_tok, D)), torch.bfloat16)
            tag = f"{b}x{s_tok}/h{D // heads}" + ("/d768" if D == 768 else "")
            check_block_kernel(
                report, "attention_block", f"attention_block/{tag}",
                fb.attention_block_branch, fb.attention_block_xla, xb, attn + (heads,),
                2.0 * b * s_tok * D * 4 * D + 4.0 * b * s_tok * s_tok * D,
                attn_lib(xb, attn, heads))
            if D == 768:
                check_block_kernel(
                    report, "mlp_block", f"mlp_block/{tag}", fb.mlp_block_branch,
                    fb.mlp_block_xla, xb, mlp, 4.0 * b * s_tok * D * hidden,
                    library_block(xb, mlp[0], mlp[1], [(mlp[2], mlp[3], True),
                                                       (mlp[4], mlp[5], False)],
                                  residual=xb))
            del xb

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for s_tok in (197, 785):
        qkv = t(rng.standard_normal((8, s_tok, 3, 12, 32)), torch.bfloat16)
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        got = at.attention_mha(q, k, v)
        want = at.attention_mha_plain(q, k, v)
        torch.cuda.synchronize()
        ok = torch.allclose(got.float(), want.float(), atol=4e-3, rtol=1e-2)
        key = f"mha/bf16/{s_tok}/h32"
        n_exp = float(8 * 12 * s_tok * s_tok)
        report("mha", got, want, "atol=4e-3 rtol=1e-2 (one bf16 ulp of the output, "
               "a p that rounds the other way)",
               cuda_ms(lambda: at.attention_mha(q, k, v)),
               cuda_ms(lambda: at.attention_mha_plain(q, k, v), warmup=1, reps=5),
               extra=f"bf16 [8 x 12, {s_tok}, 32] plan {at.mha_plan(s_tok)} ", key=key,
               work=(io_bytes(q, k, v, got), 4.0 * n_exp * 32, "bf16"),
               library_ms=cuda_ms(lambda: sdpa(q, k, v)))
        exp_line(key, n_exp, results[key]["bound_ms"])
        if not ok:
            raise AssertionError(f"{key}: kernel disagrees with plain version")
        del qkv, q, k, v, got, want


def check_train_kernels(dev, results: dict) -> None:
    """Kernel 11 and kernel 3 at the train step's shapes."""
    from timetuning_tpu_torch.ops import sinkhorn as sk_matvec
    from timetuning_tpu_torch.ops import sinkhorn_cuda as sk

    rng = np.random.default_rng(10)
    t, _ = _tensor_maker(dev, rng)
    report = _reporter(results)
    tol = "rtol=1e-4 atol=1e-8 (f32 sums in another order over 10 iterations)"

    def close(a, b):
        return torch.allclose(a, b, rtol=1e-4, atol=1e-8)

    # K11 at the score matrices of a 32- and a 128-clip step and of a
    # 32-clip step with its queue full, 10 iterations, without and with a
    # validity mask, through both entries: Q [K, B] and the step's scores
    # [B, K] (the dispatched one, exp in the load). Its plain version is the
    # matvec form (ops/sinkhorn, plain torch: ~100 launches); where nothing
    # underflows it also equals the TPU kernel's materialising loop
    for n_cols in (TRAIN_B * 196, 128 * 196, TRAIN_B * 196 + 16384):
        scores = t(rng.uniform(-1, 1, (n_cols, 200)))
        Q = torch.exp(scores / 0.05).t().contiguous()
        for valid in (None, t(rng.uniform(size=n_cols) > 0.25)):
            want = sk_matvec.sinkhorn(Q, 10, valid=valid)
            got_q = sk.sinkhorn_cuda(Q, 10, valid)
            got = sk.sinkhorn_assignment_cuda(scores, 0.05, 10, valid)
            loop = sk.sinkhorn_plain(Q, 10, valid)
            torch.cuda.synchronize()
            ok = close(got, want) and close(got_q, want) and close(got, loop)
            masked = valid is not None
            key = "sinkhorn" if (n_cols, masked) == (TRAIN_B * 196, False) else (
                f"sinkhorn/{n_cols}{'/valid' if masked else ''}")
            q_ms = cuda_ms(lambda: sk.sinkhorn_cuda(Q, 10, valid))
            loop_ms = cuda_ms(lambda: sk.sinkhorn_plain(Q, 10, valid))
            report("sinkhorn", got, want, tol + ", scores entry against the matvec form",
                   cuda_ms(lambda: sk.sinkhorn_assignment_cuda(scores, 0.05, 10, valid)),
                   cuda_ms(lambda: sk_matvec.sinkhorn(
                       torch.exp(scores / 0.05).t(), 10, valid=valid)),
                   extra=f"[200, {n_cols}]{' valid mask' if masked else ''}; Q entry "
                         f"{q_ms:.4f} ms, err {(got_q - want).abs().max().item():.3e}; "
                         f"the materialising loop {loop_ms:.4f} ms, err "
                         f"{(got - loop).abs().max().item():.3e} ",
                   key=key,
                   # a sweep multiplies and adds twice per element an iteration
                   work=(io_bytes(scores, valid, got), 200.0 * n_cols * (4 * 10 + 2), "f32"))
            if not ok:
                raise AssertionError(f"{key}: kernel disagrees with the matvec form")
        del scores, Q, want, got_q, got, loop

    # zero marginals: two all-zero rows of Q and a masked-out column
    Q = t(np.exp(rng.uniform(-1, 1, (200, TRAIN_B * 196)) / 0.05))
    Q[3], Q[150] = 0.0, 0.0
    valid = torch.ones(Q.shape[1], device=dev)
    valid[5] = 0.0
    got, want = sk.sinkhorn_cuda(Q, 10, valid), sk_matvec.sinkhorn(Q, 10, valid=valid)
    zeros = bool((got[:, 3] == 0).all() and (got[:, 150] == 0).all() and (got[5] == 0).all())
    print(f"kernel sinkhorn with two zero rows and a masked column [200, {Q.shape[1]}]: "
          f"finite {bool(torch.isfinite(got).all())}, zeros there {zeros}, max_abs_err "
          f"{(got - want).abs().max().item():.3e} against the matvec form ({tol})",
          flush=True)
    if not (torch.isfinite(got).all() and zeros and close(got, want)):
        raise AssertionError("sinkhorn: zero marginals not pinned as the matvec form pins them")

    check_propagation(dev, report, np.random.default_rng(200), 196,
                      "propagation/train", "lattice",
                      shape=(TRAIN_B, TRAIN_F, 200),
                      kw=dict(n_last=7, radius=6, topk=5))


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
        want = get_backbone(arch, dtype=torch.bfloat16, device="cpu").module(
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
    ("train", "default"): ("attention_block", "mlp_block", "propagation", "sinkhorn"),
    ("train", "pallas"): ("mha", "propagation", "sinkhorn"),
    ("train", "float32"): ("propagation", "sinkhorn"),
    ("train", "sinkhorn on the step's scores"): ("sinkhorn",),
    ("train", "driver"): ("attention_block", "mlp_block", "propagation", "sinkhorn"),
    ("eval", "pascal"): ("preprocess", "attention_block", "mlp_block"),
    ("cbfe", "float32"): (),
    ("propagate", "flow"): (),
    ("train", "kernels on the grad path"): ("attention_block", "mlp_block",
                                            "propagation", "sinkhorn"),
    ("train", "kernels on the grad path, remat"): ("attention_block", "mlp_block",
                                                   "propagation", "sinkhorn"),
    ("heads32", "mocov3-s16"): ("flash_attention", "ln_dense", "dense_residual",
                                "mlp_rows"),
    ("export", "dino-s16"): ("preprocess", "attention_block", "mlp_block"),
    ("export", "dino-s16 symbolic"): ("preprocess", "attention_block", "mlp_block"),
    ("export", "dino-s8"): ("preprocess", "ln_dense", "flash_attention",
                            "dense_residual", "mlp_rows"),
    ("parity", "float32"): ("propagation",),
    ("moe", "forward"): ("attention_block", "mlp_block"),
    ("moe", "step"): ("attention_block", "mlp_block", "propagation", "sinkhorn"),
    ("moe", "export"): ("preprocess", "attention_block", "mlp_block"),
    ("ep", "step"): ("attention_block", "mlp_block", "propagation", "sinkhorn"),
    ("tp", "step"): ("propagation", "sinkhorn"),
    ("sp", "bfloat16"): ("ln_dense", "flash_attention", "dense_residual", "mlp_rows"),
    ("sp", "float32"): ("flash_attention",),
    ("pp", "bfloat16"): ("attention_block", "mlp_block"),
    ("pp", "float32"): (),
    ("export mesh", "tp"): ("preprocess",),
    ("export mesh", "ep"): ("preprocess", "attention_block", "mlp_block"),
    ("export mesh", "sp"): ("preprocess", "ln_dense", "flash_attention", "dense_residual",
                            "mlp_rows"),
    ("export mesh", "pp"): ("preprocess", "attention_block", "mlp_block"),
    ("export mesh", "dp"): ("preprocess", "attention_block", "mlp_block"),
}   # the zoo's paths are added by run_zoo (zoo_path_kernels)


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


def _clone_tree(out):
    from torch.utils import _pytree as pytree

    return pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, out)


def _equal_trees(a, b) -> bool:
    from torch.utils import _pytree as pytree

    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    return sa == sb and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


def call_launches(fn, *args):
    """One call of ``fn``: its outputs (cloned out of a graph's memory) and
    the kernel launches it made (a graph's replay counts its kernels)."""
    from timetuning_tpu_torch.ops import kernel_lib

    torch.cuda.synchronize()
    kernel_lib.reset_launch_counts()
    out = _clone_tree(fn(*args))
    torch.cuda.synchronize()
    return out, {k: v for k, v in kernel_lib.launch_counts().items() if v}


def host_ms(fn, calls: int = 3) -> float:
    """Host ms a call of ``fn``, no synchronise between the calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return out


def busy_check(label: str, res: dict, graphed) -> None:
    """An idle share is quoted only where the trace lists the kernels inside
    a replay: the graphed busy time within 10 % of the eager one. The
    profiler has dropped some of a replay's device events (and once all of
    a short window's), so the graphed call is traced up to twice more; a
    trace that never holds them leaves the graphed idle share unmeasured
    (None)."""
    for attempt in range(3):
        if abs(res["graphed"]["busy_ms"] - res["eager"]["busy_ms"]) <= \
                0.1 * res["eager"]["busy_ms"]:
            return
        if attempt < 2:
            res["graphed"].update(trace(graphed, f"graphs {label} graphed, again", top=3))
    print(f"graphs {label}: the trace kept {res['graphed']['busy_ms']:.3f} ms of device "
          f"busy graphed against {res['eager']['busy_ms']:.3f} eager: it lost kernels "
          f"inside the replay, so the graphed idle share is not measured", flush=True)
    res["graphed"]["idle"] = None


def pct(x) -> str:
    return "not measured" if x is None else f"{100 * x:.2f} %"


def graphs_compare(label: str, graphed, eager, *args, reps: int = 5) -> dict:
    """One program graphed (``runtime.CapturedCall``) and eager on the same
    inputs: the outputs bit for bit equal on three graphed calls (the eager
    warm-up, the capture and its replay, a replay) and the kernel launches
    of a call equal; then, each way, host ms a call (no synchronise), ms a
    call (CUDA events, unqueued), peak memory over those calls and the
    trace's busy ms and idle share (``busy_check``)."""
    want, n_eager = call_launches(eager, *args)
    for i in range(3):
        got, n_graphed = call_launches(graphed, *args)
        if not _equal_trees(got, want):
            raise AssertionError(f"graphs {label}: graphed call {i} differs from eager")
        if n_graphed != n_eager:
            raise AssertionError(f"graphs {label}: graphed call {i} launched {n_graphed}, "
                                 f"eager {n_eager}")
    res = {}
    for mode, fn in (("eager", eager), ("graphed", graphed)):
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: fn(*args), warmup=1, reps=reps, queued=False)
        res[mode] = {"ms": ms, "host_ms": host_ms(lambda: fn(*args)),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     **trace(lambda: fn(*args), f"graphs {label} {mode}", top=3)}
    busy_check(label, res, lambda: graphed(*args))
    e, g = res["eager"], res["graphed"]
    print(f"graphs {label}: graphed = eager bit for bit on 3 calls, launches a call "
          f"{n_eager} both ways | ms a call (CUDA events) eager {e['ms']:.3f}, graphed "
          f"{g['ms']:.3f}; host ms a call {e['host_ms']:.3f} / {g['host_ms']:.3f}; "
          f"device busy {e['busy_ms']:.3f} / {g['busy_ms']:.3f} ms, idle "
          f"{pct(e['idle'])} / {pct(g['idle'])}; peak memory "
          f"{e['peak_gib']:.3f} / {g['peak_gib']:.3f} GiB", flush=True)
    return res


def run_eval(dev, clips, arch: str, size: int, totals: dict) -> dict:
    """The port's propagation eval (``cli/propagate``'s per-group compute and
    scoring) on ``clips`` with ``arch`` at ``size``, in bf16 through the
    kernels and in f32; fails if |J&F(bf16) - J&F(f32)| > 0.05. The groups
    run as ``cli/propagate``'s CUDA graph (one program over the warm-up and
    the counted run); then, in bf16, the ``graphs`` comparison of the group
    and of its feature extraction, graphed against eager."""
    from timetuning_tpu_torch.cli import propagate as prop
    from timetuning_tpu_torch.data.transforms import eval_preprocess_batch
    from timetuning_tpu_torch.models.registry import get_backbone
    from timetuning_tpu_torch.runtime import CapturedCall

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
        program = prop.group_program(args, bb)
        # warm-up: the group shape's eager call, then the counted run's
        # capture and replay
        prop.evaluate_clips(args, bb, clips[:1], dev, program=program)
        t0 = time.perf_counter()
        with dense_pass_rows() as k3:
            res, counts = counted(
                (arch, dtype),
                lambda: prop.evaluate_clips(args, bb, clips, dev, program=program),
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
            return program(frames, onehots)

        ms = cuda_ms(group, warmup=1, reps=5, queued=False)
        s = scores[dtype]
        print(f"eval {arch}/{size} {dtype}: J={s['J']:.6f} F={s['F']:.6f} "
              f"J&F={s['J&F']:.6f} | evaluate_clips (with host J&F) "
              f"{wall * 1e3:.1f} ms = {n / wall:.1f} frames/s | device compute "
              f"{ms:.2f} ms per {CLIPS}-clip group = {n / ms * 1e3:.1f} frames/s "
              f"| launches {counts}", flush=True)
        dense_pass_line(f"eval {arch}/{size} {dtype}", k3)
        trace(group, f"{arch}/{size} {dtype} group")

        def extract(x):
            x = eval_preprocess_batch(x.reshape((n,) + x.shape[2:]), out_size=size,
                                      compute_dtype=prop.compute_dtype(args))
            return bb.apply(x)[0]

        if dtype == "bfloat16":           # the kernels' path
            with torch.inference_mode():
                graphs_compare(f"eval {arch}/{size} {dtype} features",
                               CapturedCall(extract), extract, frames)
            res_g = graphs_compare(f"eval {arch}/{size} {dtype} group",
                                   prop.group_program(args, bb),
                                   prop.group_program(args, bb, graphed=False), frames,
                                   onehots)
            # the blocks' f32 weights cast to bf16 on every forward
            # (models/vit.py, each block's qkv, proj, fc1, fc2): kernels
            # inside the graph now, timed alone
            ws = [w for blk in bb.module.blocks for w in (
                blk.attn.qkv.weight, blk.attn.proj.weight, blk.mlp.fc1.weight,
                blk.mlp.fc2.weight)]
            cast_ms = cuda_ms(lambda: [w.t().to(torch.bfloat16) for w in ws], reps=10)
            busy = res_g["graphed"]["busy_ms"]
            print(f"graphs eval {arch}/{size} {dtype}: the {len(ws)} per-block weight "
                  f"casts alone {cast_ms:.4f} ms = {100 * cast_ms / busy:.2f} % of the "
                  f"graphed group's device busy {busy:.3f} ms", flush=True)
        del bb, program
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


def synthetic_train_clips(n_clips: int, dev, seed: int = 0) -> torch.Tensor:
    """[n_clips, 4, 224, 224, 3] f32 normalised clips with structure: three
    coloured boxes moving at constant velocity over a smooth colour gradient
    (noise frames make the propagation target degenerate), from ``seed``."""
    rng = np.random.default_rng(seed)
    lin = torch.linspace(0.0, 1.0, S, device=dev)
    yy, xx = lin[:, None], lin[None, :]

    def u(lo, hi, *shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)

    bg_a, bg_b = u(-1, 1, n_clips, 1, 1, 1, 3), u(-1, 1, n_clips, 1, 1, 1, 3)
    clips = (bg_a * yy[None, None, :, :, None] + bg_b * xx[None, None, :, :, None]
             ).expand(n_clips, TRAIN_F, S, S, 3).clone()
    times = torch.arange(TRAIN_F, dtype=torch.float32, device=dev)[None, :, None, None]
    for _ in range(3):
        color = u(-2, 2, n_clips, 1, 1, 1, 3)
        pos, vel = u(0.15, 0.85, n_clips, 2), u(-0.06, 0.06, n_clips, 2)
        half = u(0.06, 0.18, n_clips)[:, None, None, None]
        cy = pos[:, 0, None, None, None] + vel[:, 0, None, None, None] * times
        cx = pos[:, 1, None, None, None] + vel[:, 1, None, None, None] * times
        inside = ((yy[None, None] - cy).abs() < half) & ((xx[None, None] - cx).abs() < half)
        clips = torch.where(inside[..., None], color, clips)
    return clips


def build_train(dev, dtype, attn_impl: str = "auto", seed: int = 0,
                remat: bool = False, zero1: bool = False, moe: bool = False,
                shard=None, mesh=None, **cfg_kw):
    """The reference's flagship at full width (time_tuning.py:573-577): DINO
    ViT-S/16 at 224, head [1024, 1024, 512, 256], 200 prototypes, seeded
    random weights; blocks 10 and 11, the head and the prototypes trainable
    over a shared frozen trunk of 10 blocks, AdamW over the trainable
    subtree. ``remat``: ``ViTConfig.remat``; ``cfg_kw``: more
    ``TimeTConfig`` fields (``axis_name`` and ``world_size`` for the data
    axis); ``zero1``: the optimizer state split over its ranks. ``moe``: the
    MoE ViT upcycled from the same seed's dense weights (``moe_vit``);
    ``shard(model)`` keeps a rank's slices before the optimizer is built,
    and ``mesh`` is the 2-D mesh of the step."""
    from timetuning_tpu_torch.core.optimizer import swav_optimizer, swav_optimizer_zero1
    from timetuning_tpu_torch.core.timet import (
        TimeT,
        TimeTConfig,
        init_state,
        make_train_step,
    )
    from timetuning_tpu_torch.models.extractor import FeatureExtractor
    from timetuning_tpu_torch.models.vit import VisionTransformer, vit_small

    vcfg = vit_small(16, img_size=S, dtype=dtype, attn_impl=attn_impl, remat=remat)
    if moe:
        vcfg = dataclasses.replace(vcfg, moe_every_k=MOE_EVERY_K, n_experts=MOE_EXPERTS,
                                   moe_capacity_factor=MOE_CAPACITY)
    vit = VisionTransformer(vcfg)
    model = TimeT(FeatureExtractor(vit, 384, (1024, 1024, 512, 256)), 200)
    model.init_weights(torch.Generator().manual_seed(seed))
    if moe:
        vit.load_state_dict(moe_vit(dtype, seed)[1].state_dict())
    model.to(dev)
    if shard is not None:
        shard(model)
    cfg = TimeTConfig(n_prototypes=200, use_teacher=True, frozen_trunk_blocks=10,
                      n_last_frames=7, size_mask_neighborhood=6, topk=5,
                      num_epochs=1, steps_per_epoch=100, spatial_resolution=S // 16,
                      **cfg_kw)
    if zero1:
        from timetuning_tpu_torch.parallel.mesh import data_rank

        opt, mask, _ = swav_optimizer_zero1(
            model, world_size=cfg.world_size, rank=data_rank(), lr=1e-4, num_epochs=1,
            steps_per_epoch=100)
    else:
        opt, mask = swav_optimizer(model, lr=1e-4, num_epochs=1, steps_per_epoch=100,
                                   opt_over_trainable=True)
    state = init_state(model, cfg, opt, trainable_mask=mask, mesh=mesh)
    step = make_train_step(model, cfg, opt, trainable_mask=mask,
                           opt_over_trainable=True, mesh=mesh)
    return model, cfg, mask, state, step


def _params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def check_train_state(label, model, mask, state, before, teacher_before) -> None:
    """After some steps: trainable leaves changed, frozen leaves
    bit-identical, every value finite, the teacher between its old value and
    the student (the EMA's weights are in [0, 1]), prototypes of unit norm."""
    after = dict(model.named_parameters())
    for n, p in after.items():
        if not torch.isfinite(p).all():
            raise AssertionError(f"{label}: {n} is not finite")
        if torch.equal(p, before[n]) == mask[n]:
            raise AssertionError(f"{label}: {n} {'did not change' if mask[n] else 'changed'}")
    if set(state.teacher) != {n for n, m in mask.items() if m}:
        raise AssertionError(f"{label}: the teacher holds other than the trainable leaves")
    for n, t in state.teacher.items():
        if n == "prototypes":          # renormalised after the EMA
            continue
        old, s = teacher_before[n], after[n].detach()
        lo, hi = torch.minimum(old, s), torch.maximum(old, s)
        slack = 1e-6 * (1 + hi.abs())
        if not bool(((t >= lo - slack) & (t <= hi + slack)).all()):
            raise AssertionError(f"{label}: teacher leaf {n} left [old, student]")
    for name, protos in (("student", model.prototypes), ("teacher", state.teacher["prototypes"])):
        norms = torch.linalg.vector_norm(protos.detach(), dim=-1)
        if not torch.allclose(norms, torch.ones_like(norms), atol=1e-5):
            raise AssertionError(f"{label}: {name} prototypes are not of unit norm")


def train_split(model, cfg, state, clip) -> None:
    """Where a default-configuration step's device time goes: each part of
    ``core/timet.step_fn`` called alone through the model's own entry points
    and timed with CUDA events (the parts do not add up to the step exactly:
    the step overlaps nothing but also allocates differently)."""
    from timetuning_tpu_torch.ops.propagation import propagate_labels_batch
    from timetuning_tpu_torch.ops.sinkhorn import sinkhorn, sinkhorn_assignment

    B, Fr = clip.shape[:2]
    fe, split = model.feature_extractor, cfg.frozen_trunk_blocks
    frames = clip.reshape(B * Fr, S, S, 3)
    named = dict(model.named_parameters())
    train = [named[n] for n in state.teacher]
    with torch.no_grad():
        trunk = fe.backbone(frames, stop_block=split)["hidden"]
        bb, _ = model(trunk, use_head=False, start_block=split)
        first = trunk.reshape(B, Fr, *trunk.shape[1:])[:, 0]
        src, _ = model(first, start_block=split)
        scores = model.similarity(src.reshape(-1, src.shape[-1]))
        q = sinkhorn_assignment(scores, cfg.epsilon, cfg.sinkhorn_iterations)
        q = q.reshape(B, -1, q.shape[-1]).transpose(1, 2)
        bb = bb.reshape(B, Fr, *bb.shape[1:])
        labels = propagate_labels_batch(bb, q, n_last=cfg.n_last_frames,
                                        radius=cfg.size_mask_neighborhood,
                                        topk=cfg.topk)[:, -1].argmax(dim=1)
        last = trunk.reshape(B, Fr, *trunk.shape[1:])[:, -1]

    def nograd(fn):
        def run():
            with torch.no_grad():
                return fn()
        return run

    def student(backward: bool):
        def run():
            feats, _ = model(last, start_block=split, attn_impl="xla")
            logits = model.similarity(feats) / cfg.score_temperature
            loss = torch.nn.functional.cross_entropy(logits.flatten(0, 1), labels.flatten())
            if backward:
                for p, g in zip(train, torch.autograd.grad(loss, train)):
                    p.grad = g
        return run

    def update():
        state.opt.step()
        for n, t in state.teacher.items():
            t.mul_(0.005).add_(named[n].detach() * 0.995)

    student(True)()
    parts = {
        "trunk, 10 blocks over all frames":
            nograd(lambda: fe.backbone(frames, stop_block=split)),
        "no-grad tail over all frames":
            nograd(lambda: model(trunk, use_head=False, start_block=split)),
        "teacher tail + head, first frames": nograd(lambda: model(first, start_block=split)),
        "scores + Sinkhorn (kernel 11, the step's)": nograd(lambda: sinkhorn_assignment(
            model.similarity(src.reshape(-1, src.shape[-1])), cfg.epsilon,
            cfg.sinkhorn_iterations)),
        "scores + Sinkhorn (matvec form)": nograd(lambda: sinkhorn(torch.exp(
            model.similarity(src.reshape(-1, src.shape[-1])) / cfg.epsilon).t(),
            cfg.sinkhorn_iterations)),
        "propagation, 200 channels": nograd(lambda: propagate_labels_batch(
            bb, q, n_last=cfg.n_last_frames, radius=cfg.size_mask_neighborhood,
            topk=cfg.topk)),
        "student forward (plain attention)": nograd(student(False)),
        "student forward + backward": student(True),
        "AdamW + EMA": nograd(update),
    }
    for name, fn in parts.items():
        print(f"train split B={B}: {cuda_ms(fn, warmup=2, reps=10, queued=False):8.3f} ms  {name}",
              flush=True)
    # the two Sinkhorn forms' device work: one launch, or the matvec form's
    # loop of small launches
    for name in ("scores + Sinkhorn (kernel 11, the step's)",
                 "scores + Sinkhorn (matvec form)"):
        trace(parts[name], f"train split B={B} {name}", reps=5, top=3)
    state.opt.zero_grad()


def run_train(dev, totals: dict) -> dict:
    """Phases 7 and 8: the train step in its two configurations at full
    width, and kernel 11 on a real step's scores. Returns the default
    configuration's first loss and first update of two leaves."""
    from timetuning_tpu_torch.core import timet
    from timetuning_tpu_torch.ops import sinkhorn as sk_matvec
    from timetuning_tpu_torch.ops import sinkhorn_cuda as sk

    clip = synthetic_train_clips(TRAIN_B, dev)
    probe = "feature_extractor.backbone.blocks.10.attn.qkv.weight"
    head_leaf = "feature_extractor.head.lin3.weight"

    # every step's score matrix and assignment, as the step computes them
    seen = {}
    assign = timet.sinkhorn_assignment

    def recording_assign(scores, *a, **kw):
        seen["scores"], seen["q"] = scores, assign(scores, *a, **kw)
        return seen["q"]

    timet.sinkhorn_assignment = recording_assign
    first_losses, first_updates = {}, {}
    try:
        for config, impl, n_steps in (("default", "auto", 6), ("pallas", "pallas", 3)):
            model, cfg, mask, state, step = build_train(dev, torch.bfloat16, impl)
            before = _params(model)
            teacher_before = {n: t.clone() for n, t in state.teacher.items()}
            losses, times = [], []
            torch.cuda.reset_peak_memory_stats()

            def steps():
                for i in range(n_steps):
                    if i == 1:
                        first_updates[config] = {
                            n: dict(model.named_parameters())[n].detach() - before[n]
                            for n in (probe, head_leaf)}
                    if i == n_steps - 1:     # the EMA check is of the last step
                        teacher_before.update(
                            {n: t.clone() for n, t in state.teacher.items()})
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    ev[0].record()
                    _, metrics = step(state, clip)
                    ev[1].record()
                    losses.append(metrics["loss"])
                    times.append(ev)

            with dense_pass_rows() as k3:
                _, counts = counted(("train", config), steps, totals)
            dense_pass_line(f"train {config} B={TRAIN_B} bf16", k3)
            losses = [float(v) for v in losses]
            ms = [a.elapsed_time(b) for a, b in times][2:]
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            first_losses[config] = losses[0]
            print(f"train {config} (attn_impl={impl}) B={TRAIN_B} bf16: losses "
                  f"{[round(v, 5) for v in losses]} | launches {counts}", flush=True)
            if ms:
                step_ms = float(np.mean(ms))
                print(f"train {config} B={TRAIN_B}: step {step_ms:.3f} ms (CUDA events, "
                      f"steps 3-{n_steps}: {[round(v, 3) for v in ms]}) = "
                      f"{TRAIN_B / step_ms * 1e3:.1f} clips/s, peak memory "
                      f"{peak:.3f} GiB", flush=True)
            if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
                raise AssertionError(f"train {config}: losses {losses} are not finite "
                                     "or did not fall on a repeated batch")
            check_train_state(f"train {config}", model, mask, state, before,
                              teacher_before)
            # per step: 10 trunk blocks + 2 tail blocks over all frames + 2
            # teacher tail blocks without grad; the grad path's 2 blocks run
            # plain attention (default) or kernel 10 (forced)
            want = ({"attention_block": 14 * n_steps, "mlp_block": 14 * n_steps,
                     "mha": 0} if config == "default" else
                    {"attention_block": 0, "mlp_block": 0, "mha": 16 * n_steps})
            want["propagation"] = want["sinkhorn"] = n_steps
            got = {k: counts[k] for k in want}
            if got != want:
                raise AssertionError(f"train {config}: launches {got}, expected {want}")

            if config == "default":
                trace(lambda: step(state, clip), f"train default B={TRAIN_B} step")
                train_split(model, cfg, state, clip)
                # the last step's own assignment (kernel 11) against the
                # matvec form and the materialising loop on its scores
                scores, q_step = seen["scores"], seen["q"]
                n_it = cfg.sinkhorn_iterations
                Q = torch.exp(scores / cfg.epsilon).t().contiguous()
                (got11,), _ = counted(
                    ("train", "sinkhorn on the step's scores"),
                    lambda: (sk.sinkhorn_assignment_cuda(scores, cfg.epsilon, n_it),),
                    totals)
                matvec = sk_matvec.sinkhorn(Q, n_it)
                loop = sk.sinkhorn_plain(Q, n_it)
                err_step = (q_step - matvec).abs().max().item()
                err_loop = (q_step - loop).abs().max().item()
                print(f"kernel sinkhorn, the step's own assignment on its scores "
                      f"[{scores.shape[0]}, 200]: max_abs_err {err_step:.3e} against the "
                      f"matvec form, {err_loop:.3e} against the materialising loop (bound "
                      f"rtol=1e-4 atol=1e-8), zero rows of Q: "
                      f"{int((Q.sum(dim=1) == 0).sum())} | kernel "
                      f"{cuda_ms(lambda: sk.sinkhorn_assignment_cuda(scores, cfg.epsilon, n_it)):.4f}"
                      f" ms, the matvec form "
                      f"{cuda_ms(lambda: sk_matvec.sinkhorn(torch.exp(scores / cfg.epsilon).t(), n_it)):.4f}"
                      f" ms, the loop {cuda_ms(lambda: sk.sinkhorn_plain(Q, n_it)):.4f} ms",
                      flush=True)
                if not (torch.allclose(q_step, matvec, rtol=1e-4, atol=1e-8)
                        and torch.equal(got11, q_step)):
                    raise AssertionError("sinkhorn kernel disagrees on the step's scores")
                del Q, got11, matvec, loop

                # one configuration at 128 clips: a warm-up and two timed steps
                big = synthetic_train_clips(128, dev, seed=1)
                torch.cuda.reset_peak_memory_stats()
                step(state, big)
                ms128 = cuda_ms(lambda: step(state, big), warmup=0, reps=2, queued=False)
                print(f"train default B=128: step {ms128:.3f} ms = "
                      f"{128 / ms128 * 1e3:.1f} clips/s, peak memory "
                      f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB", flush=True)
                del big
            else:
                ms3 = cuda_ms(lambda: step(state, clip), warmup=0, reps=3, queued=False)
                print(f"train {config} B={TRAIN_B}: step {ms3:.3f} ms over 3 more steps "
                      f"= {TRAIN_B / ms3 * 1e3:.1f} clips/s", flush=True)
            del model, state, step
    finally:
        timet.sinkhorn_assignment = assign

    # the forced configuration against the default one, from the same
    # weights on the same batch: the first loss, and the first update of a
    # head leaf and of a leaf that only gets its gradient through attention
    # (Adam's first update is -lr * sign(g): compare the signs). The two
    # round to bf16 at other places; found on an H100: 2.4e-4 relative on the
    # loss and 0.984 / 0.988 of the signs equal, so the gates are 2e-3 and
    # 0.95
    rel = abs(first_losses["pallas"] - first_losses["default"]) / first_losses["default"]
    agree = {n: float((torch.sign(first_updates["pallas"][n])
                       == torch.sign(first_updates["default"][n])).float().mean())
             for n in (probe, head_leaf)}
    print(f"train pallas vs default, step 1: loss {first_losses['pallas']:.6f} vs "
          f"{first_losses['default']:.6f} (relative {rel:.3e}, gate 2e-3); update sign "
          f"agreement {agree} (gate 0.95)", flush=True)
    if rel > 2e-3 or min(agree.values()) < 0.95:
        raise AssertionError("the forced configuration's first step disagrees with "
                             "the default one's")
    if float(first_updates["pallas"][probe].abs().max()) == 0:
        raise AssertionError("no gradient reached block 10's qkv through kernel 10")
    return {"loss": first_losses["default"], "update": first_updates["default"]}


def run_train_f32_against_host(dev, totals: dict) -> None:
    """Phase 9: one f32 step of the full model at 2 clips on the card (plain
    attention, kernel 3) against the same step on the host: the loss, and
    the update of one leaf (Adam's first update is -lr * sign(g), so a
    gradient entry at rounding level may flip: gate on the share of equal
    entries)."""
    clip = synthetic_train_clips(2, dev, seed=2)
    leaf = "feature_extractor.backbone.blocks.11.mlp.fc2.weight"
    out = {}
    for where, device in (("card", dev), ("host", torch.device("cpu"))):
        model, _, _, state, step = build_train(device, torch.float32)
        before = dict(model.named_parameters())[leaf].detach().clone()
        run = lambda: step(state, clip.to(device))      # noqa: E731
        if where == "card":
            with dense_pass_rows() as k3:
                (_, metrics), _ = counted(("train", "float32"), run, totals)
            dense_pass_line("train f32 B=2", k3)
        else:
            _, metrics = run()
        out[where] = (float(metrics["loss"]),
                      (dict(model.named_parameters())[leaf].detach() - before).cpu())
    (l_card, u_card), (l_host, u_host) = out["card"], out["host"]
    rel = abs(l_card - l_host) / abs(l_host)
    same = float((torch.sign(u_card) == torch.sign(u_host)).float().mean())
    close = float(torch.isclose(u_card, u_host, rtol=1e-3, atol=1e-7).float().mean())
    print(f"train f32 B=2, card vs host: loss {l_card:.6f} vs {l_host:.6f} (relative "
          f"{rel:.3e}, gate 1e-3); {leaf} update: {same:.4f} of the entries with equal "
          f"sign, {close:.4f} equal to rtol 1e-3 (gate 0.98)", flush=True)
    if not (np.isfinite(l_card) and rel <= 1e-3 and same >= 0.98 and close >= 0.98):
        raise AssertionError("the f32 step on the card disagrees with the host's")


DRIVER_NATIVE = (480, 854)          # the synthetic clips' native size
DRIVER_BANK = 8                     # distinct clips the synthetic dataset serves
DRIVER_STEPS_128 = 10               # steps of the 128-clip driver epoch


def synthetic_clip_bank(n: int, frames: int, size: int, seed: int = 5):
    """[n, frames, size, size, 3] uint8 decode buffers: three coloured boxes
    moving over a colour gradient, from ``seed``; and each frame's PIL gray
    mean (``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``, averaged)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    bank = np.empty((n, frames, size, size, 3), np.uint8)
    for c in range(n):
        a, b = rng.uniform(30, 220, (2, 3))
        base = a * yy[..., None] + b * xx[..., None]
        boxes = [(rng.uniform(0.15, 0.85, 2), rng.uniform(-0.06, 0.06, 2),
                  rng.uniform(0.06, 0.18), rng.integers(0, 256, 3)) for _ in range(3)]
        for f in range(frames):
            img = base.copy()
            for pos, vel, half, color in boxes:
                cy, cx = pos + vel * f
                img[(np.abs(yy - cy) < half) & (np.abs(xx - cx) < half)] = color
            bank[c, f] = np.clip(img, 0, 255).astype(np.uint8)
    u = bank.astype(np.int64)
    lum = (19595 * u[..., 0] + 38470 * u[..., 1] + 7471 * u[..., 2] + 32768) >> 16
    return bank, lum.mean(axis=(-2, -1)).astype(np.float32)


class SyntheticVideoDataset:
    """A dataset for ``data/loader.ClipLoader`` that serves seeded clips in
    place of decoded video (the card's machine may lack cv2 and PIL, the
    decoders of the port's loaders): ``n_videos`` clips cycling through a
    bank of ``DRIVER_BANK`` distinct ones, each with its native size and its
    frames' gray means, in the item layout of ``data/datasets.VideoDataset``
    (one clip a video)."""

    def __init__(self, n_videos: int, num_frames: int, decode_size: int):
        self.n = n_videos
        self.bank, self.gray = synthetic_clip_bank(DRIVER_BANK, num_frames, decode_size)

    def __len__(self):
        return self.n

    def get_item(self, index: int, epoch: int | None = None) -> dict:
        c = index % DRIVER_BANK
        F = self.bank.shape[1]
        return {"frames": self.bank[c][None].copy(),
                "annotations": np.zeros((1, F, 1, 1), np.uint8), "label": index,
                "orig_size": np.asarray(DRIVER_NATIVE, np.int32),
                "gray_means": self.gray[c][None].copy()}


def register_synthetic_dataset() -> str:
    from timetuning_tpu_torch.data.loader import register_dataset

    name = "chip_smoke_synthetic"

    @register_dataset(name)
    def _build(_name, root, num_frames=4, decode_size=256, **_kw):
        return SyntheticVideoDataset(int(root), num_frames, decode_size)

    return name


def driver_config(dev, log_dir: str, batch: int, **kw):
    """The flagship's driver configuration (time_tuning.py:573-577 and the
    reference's training flags): dino-s16 at 224, head [1024, 1024, 512,
    256], 200 prototypes, bf16, 4-frame clips from a 256 buffer, 4 loader
    workers; the data are the synthetic dataset's, as many clips as the
    epoch's steps take."""
    from timetuning_tpu_torch.core.train import TrainingConfig

    steps = kw.get("max_steps_per_epoch", 4)
    base = dict(architecture="dino-s16", dataset=register_synthetic_dataset(),
                data_root=str(steps * batch), log_dir=log_dir, batch_size=batch,
                num_frames=4, decode_size=256, num_workers=4, num_clusters=200,
                input_resolution=224, compute_dtype="bfloat16", num_epochs=2,
                max_steps_per_epoch=4, use_tensorboard=False, device=str(dev))
    base.update(kw)
    return TrainingConfig(**base)


@contextlib.contextmanager
def step_times(marker: str = "chip_smoke.driver_step"):
    """While open, every full step of ``core/train.run_training`` is timed on
    the host and marked in a profiler trace, and every checkpoint save is
    timed; yields a namespace with ``steps``, the (entry, exit) times (s) of
    each step, and ``saves``, each save's ms. Inside a step: the draw, the
    augmentation's and the step's launches (and whatever of them waits for
    the card); between two: the previous loss read back, the loader's next
    batch, its pinned copy queued, and at an epoch's top its save."""
    import types

    from torch.profiler import record_function

    from timetuning_tpu_torch.core import train as ttrain

    rec = types.SimpleNamespace(steps=[], saves=[])
    make, save = ttrain.make_full_step, ttrain.save_checkpoint

    def timed_make(*a, **kw):
        full = make(*a, **kw)

        def step(*args, **kwargs):
            t0 = time.perf_counter()
            with record_function(marker):
                out = full(*args, **kwargs)
            rec.steps.append((t0, time.perf_counter()))
            return out
        return step

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        out = save(*a, **kw)
        rec.saves.append((time.perf_counter() - t0) * 1e3)
        return out

    ttrain.make_full_step, ttrain.save_checkpoint = timed_make, timed_save
    try:
        yield rec
    finally:
        ttrain.make_full_step, ttrain.save_checkpoint = make, save


def driver_rates(rec, B: int, per_epoch: int, skip: int = 1) -> dict:
    """The driver's rates from its step entries (host clock), the first
    ``skip`` steps (the warm-up) left out: ``window`` = B x steps / the time
    from the first steady entry to the last (all the work of the window,
    epoch-top saves included), ``in_epoch`` the same over the steps whose
    gap stays inside an epoch (no save, no loader restart), ``median`` the
    median ms entry to entry; ``gaps`` each step's ms; ``inside`` /
    ``between`` the median ms of a step's host time inside the full step
    and between two."""
    entry = np.array([a for a, _ in rec.steps])
    inside = np.array([b - a for a, b in rec.steps])
    gaps = np.diff(entry)[skip:]
    k = np.arange(skip, len(entry) - 1)         # gap k: entry k -> k + 1
    same = (k + 1) % per_epoch != 0
    return {"steps": len(gaps), "window_ms": float(entry[-1] - entry[skip]) * 1e3,
            "window": B * len(gaps) / float(entry[-1] - entry[skip]),
            "in_epoch_steps": int(same.sum()),
            "in_epoch": B * int(same.sum()) / float(gaps[same].sum()),
            "median": float(np.median(gaps)) * 1e3,
            "gaps": [round(float(g) * 1e3, 2) for g in gaps],
            "inside": float(np.median(inside[skip + 1:])) * 1e3,
            "between": float(np.median(gaps - inside[skip:-1])) * 1e3}


def driver_losses(run_dir: str) -> dict:
    import os

    rows = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    return {r["step"]: r["value"] for r in rows if r["tag"] == "Loss/train"}


def loader_alone(dev, B: int, n: int = 6) -> float:
    """ms a batch of the driver's loader and copy alone: ``make_loader`` over
    the synthetic dataset at ``B`` clips, each batch put on the card as
    ``run_training`` puts it (pinned, copied on a side stream)."""
    from timetuning_tpu_torch.data.loader import (
        device_prefetch,
        host_batch_to_device,
        make_loader,
    )

    loader = make_loader(register_synthetic_dataset(), num_clip_frames=4,
                         batch_size=B, root=str((n + 1) * B), decode_size=256,
                         num_workers=4, load_annotations=False)
    side = torch.cuda.Stream(dev)
    stamps = []
    for frames, sizes, gmeans in device_prefetch(
            loader, lambda b: tuple(host_batch_to_device(a, dev)
                                    for a in (b[0], b.orig_sizes, b.gray_means)),
            stream=side):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    return float(np.median(np.diff(stamps))) * 1e3


def augment_launches(dev, B: int) -> dict:
    """The augmentation alone at ``B`` clips of 4 frames, 256 -> 224, on the
    card, traced over 3 calls: its device busy time and device events a call
    (kernels only: the drawn values are uploaded before), and its host time
    a call (the host enqueues ~320 launches); the host ms of a batch's draw
    and its pinned upload."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from timetuning_tpu_torch.data import transforms as tf

    cfg = tf.AugmentConfig()
    bank, gray = synthetic_clip_bank(DRIVER_BANK, 4, 256)
    idx = np.arange(B) % DRIVER_BANK
    frames = torch.from_numpy(bank[idx]).to(dev)
    sizes = torch.tensor([DRIVER_NATIVE] * B, device=dev)
    gmeans = torch.from_numpy(gray[idx]).to(dev)
    params = tf.draw_augment_params(torch.Generator().manual_seed(B), B, 4, cfg)
    params = params.pin_memory().to(dev, non_blocking=True)

    def run():
        return tf.apply_augment(frames, params, cfg, sizes, gmeans)

    wall_ms = cuda_ms(run, warmup=2, reps=10, queued=False)
    # the driver's draw of a batch's values on the host and their upload,
    # as make_full_step does them
    t0 = time.perf_counter()
    for s in range(10):
        tf.draw_augment_params(torch.Generator().manual_seed(s), B, 4, cfg) \
            .pin_memory().to(dev, non_blocking=True)
    torch.cuda.synchronize()
    draw_ms = (time.perf_counter() - t0) / 10 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke.trace"):
            for _ in range(3):
                run()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    win = next(e for e in events if e.name() == "chip_smoke.trace"
               and e.device_type() == DeviceType.CPU)
    out = device_time(events, win.start_ns(), win.end_ns(), 3,
                      f"train augment B={B} (apply_augment alone)", top=4)
    # launches as the host made them (the runtime's launch calls): the
    # device events the profiler keeps of ~300 short kernels vary by call
    launches = sum(1 for e in events if e.device_type() == DeviceType.CPU
                   and "LaunchKernel" in e.name()) / 3
    return {**out, "wall_ms": wall_ms, "launches": launches, "draw_ms": draw_ms}


def run_train_driver(dev, totals: dict) -> None:
    """Phase 10: ``core/train.run_training`` at the flagship's full width on
    the synthetic dataset: 2 epochs of 4 steps at 32 clips, then a resume
    (``load_checkpoint``) for a third epoch under the profiler; one epoch of
    ``DRIVER_STEPS_128`` steps at 128 clips; the augmentation alone at 32 and 128 clips; the
    bare step (pre-augmented clips on the card) at both sizes."""
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from timetuning_tpu_torch.core.train import run_training

    print("decoders on this machine: " + ", ".join(
        f"{m} {'yes' if importlib.util.find_spec(m) else 'no'}" for m in ("cv2", "PIL"))
        + " (the driver phases read the synthetic dataset either way)", flush=True)
    with tempfile.TemporaryDirectory() as log_dir:
        torch.cuda.reset_peak_memory_stats()
        with step_times() as t32:
            first, c1 = counted(("train", "driver"),
                                lambda: run_training(driver_config(dev, log_dir, 32)),
                                totals)
        with step_times():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                resumed, c2 = counted(
                    ("train", "driver"),
                    lambda: run_training(driver_config(dev, log_dir, 32, num_epochs=3,
                                                       load_checkpoint=True)),
                    totals)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = driver_losses(resumed["run_dir"])
    steps = sorted(losses)
    vals = [losses[s] for s in steps]
    print(f"train driver B=32: {first['global_step']} steps in 2 epochs, resumed at "
          f"step {first['global_step']} to {resumed['global_step']} in "
          f"{resumed['run_dir'] == first['run_dir'] and 'the same run dir'}; losses "
          f"{[round(v, 5) for v in vals]} | launches {c1} then {c2}", flush=True)
    if not (first["global_step"] == 8 and resumed["global_step"] == 12
            and resumed["run_dir"] == first["run_dir"] and steps == list(range(1, 13))):
        raise AssertionError("train driver: the run did not resume at its saved step")
    if not (np.isfinite(vals).all() and np.mean(vals[-4:]) < np.mean(vals[:4])):
        raise AssertionError(f"train driver: losses {vals} are not finite or did not fall")
    for counts, n in ((c1, 8), (c2, 4)):
        want = {"attention_block": 14 * n, "mlp_block": 14 * n, "propagation": n,
                "sinkhorn": n}
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"train driver: launches {counts}, expected {want}")

    # the resumed epoch's steady steps under the profiler: from the start of
    # its second step to the start of its last
    events = prof.profiler.kineto_results.events()
    # (the resumed state's tensors are new: its first step runs eagerly, its
    # second captures the step's graph)
    marks = sorted(e.start_ns() for e in events if e.name() == "chip_smoke.driver_step"
                   and e.device_type() == DeviceType.CPU)
    idle = device_time(events, marks[2], marks[-1], len(marks) - 3,
                       "train driver B=32 (loader + copy + augmentation + step)")["idle"]

    r32 = driver_rates(t32, 32, per_epoch=4, skip=2)
    with tempfile.TemporaryDirectory() as log_dir:
        with step_times() as t128:
            big, _ = counted(("train", "driver"),
                             lambda: run_training(driver_config(
                                 dev, log_dir, 128, num_epochs=1,
                                 max_steps_per_epoch=DRIVER_STEPS_128)), totals)
        peak128 = torch.cuda.max_memory_allocated() / 2 ** 30
    r128 = driver_rates(t128, 128, per_epoch=DRIVER_STEPS_128, skip=2)
    if big["global_step"] != DRIVER_STEPS_128:
        raise AssertionError(f"train driver B=128: {big['global_step']} steps")

    def rates(r, B):
        return (f"B={B} {r['window']:.1f} clips/s over the window ({r['steps']} steps "
                f"in {r['window_ms']:.3f} ms), {r['in_epoch']:.1f} clips/s over its "
                f"{r['in_epoch_steps']} steps inside an epoch; median "
                f"{r['median']:.3f} ms a step = {B / r['median'] * 1e3:.1f} clips/s "
                f"(steps {r['gaps']})")

    print(f"train driver wall, host clock entry to entry (the eager warm-up step and "
          f"the step that captures the graph excluded; every step waits for the "
          f"previous one's loss): {rates(r32, 32)}; "
          f"{rates(r128, 128)}; checkpoint saves {[round(v, 1) for v in t32.saves]} ms "
          f"at B=32 (the second is the epoch-top save inside the window); of a step, "
          f"inside the full step {r32['inside']:.3f} / {r128['inside']:.3f} ms (draw "
          f"+ augmentation + step launches), between steps {r32['between']:.3f} / "
          f"{r128['between']:.3f} ms (previous loss read back, loader, pinned copy "
          f"queued); peak memory {peak:.3f} GiB at B=32, {peak128:.3f} GiB at B=128; "
          f"device idle {100 * idle:.2f} % at B=32", flush=True)
    loader_ms = {B: loader_alone(dev, B) for B in (32, 128)}
    print(f"train loader alone (ClipLoader over the synthetic dataset, 4 workers, "
          f"batches pinned and copied to the card, 6 batches after one): B=32 "
          f"{loader_ms[32]:.3f} ms a batch, B=128 {loader_ms[128]:.3f} ms", flush=True)
    if not np.isfinite(big["final_loss"]):
        raise AssertionError("train driver B=128: the loss is not finite")

    aug = {B: augment_launches(dev, B) for B in (32, 128)}
    print(f"train augment (apply_augment alone, 4 frames 256 -> 224): B=32 "
          f"{aug[32]['launches']:.0f} kernel launches, device busy "
          f"{aug[32]['busy_ms']:.4f} ms, {aug[32]['wall_ms']:.4f} ms a call unqueued "
          f"(CUDA events, the host's enqueueing included); B=128 "
          f"{aug[128]['launches']:.0f} launches, {aug[128]['busy_ms']:.4f} ms busy, "
          f"{aug[128]['wall_ms']:.4f} ms unqueued; the draw and its pinned upload "
          f"on the host {aug[32]['draw_ms']:.3f} / {aug[128]['draw_ms']:.3f} ms",
          flush=True)
    if aug[32]["launches"] != aug[128]["launches"]:
        raise AssertionError("train augment: its launch count grows with the batch")

    # the bare step on pre-augmented clips in the same call
    bare = {}
    for B in (32, 128):
        model, cfg, mask, state, step = build_train(dev, torch.bfloat16)
        clip = synthetic_train_clips(B, dev, seed=B)
        step(state, clip)
        bare[B] = cuda_ms(lambda: step(state, clip), warmup=1, reps=4, queued=False)
        del model, state, step, clip
    print(f"train bare step (pre-augmented clips on the card, CUDA events, same "
          f"call): B=32 {bare[32]:.3f} ms = {32 / bare[32] * 1e3:.1f} clips/s; B=128 "
          f"{bare[128]:.3f} ms = {128 / bare[128] * 1e3:.1f} clips/s; the driver "
          f"adds {32e3 / r32['in_epoch'] - bare[32]:.3f} / "
          f"{128e3 / r128['in_epoch'] - bare[128]:.3f} ms a step inside an epoch (the "
          f"augmentation alone, unqueued: {aug[32]['wall_ms']:.3f} / "
          f"{aug[128]['wall_ms']:.3f}; the loader and copy alone: "
          f"{loader_ms[32]:.3f} / {loader_ms[128]:.3f}; the draw: "
          f"{aug[32]['draw_ms']:.3f} / {aug[128]['draw_ms']:.3f})", flush=True)


GRAPH_STEPS = 6                     # flagship steps a configuration of the graphs phase
GRAPH_QUEUE = 960                   # rows of its queue: 320 stored a step, ready at step 3


def graphs_step(dev, attn_impl: str, graphed: bool):
    """The flagship's full step (``core/train.make_full_step``: augmentation
    + step) at full width, seeded, bf16, with a queue of ``GRAPH_QUEUE``
    rows and the lr, weight-decay and EMA-momentum schedules cosine over
    ``GRAPH_STEPS`` steps, so that a value frozen into a graph shows from
    step 2 on; graphed or eager."""
    from timetuning_tpu_torch.core.optimizer import swav_optimizer
    from timetuning_tpu_torch.core.timet import TimeT, TimeTConfig, init_state
    from timetuning_tpu_torch.core.train import make_full_step
    from timetuning_tpu_torch.data.transforms import AugmentConfig
    from timetuning_tpu_torch.models.extractor import FeatureExtractor
    from timetuning_tpu_torch.models.vit import VisionTransformer, vit_small

    vit = VisionTransformer(vit_small(16, img_size=S, dtype=torch.bfloat16,
                                      attn_impl=attn_impl))
    model = TimeT(FeatureExtractor(vit, 384, (1024, 1024, 512, 256)), 200)
    model.init_weights(torch.Generator().manual_seed(0)).to(dev)
    sched = dict(num_epochs=1, steps_per_epoch=GRAPH_STEPS)
    cfg = TimeTConfig(n_prototypes=200, frozen_trunk_blocks=10, n_last_frames=7,
                      size_mask_neighborhood=6, topk=5, spatial_resolution=S // 16,
                      use_queue=True, queue_size=GRAPH_QUEUE, **sched)
    opt, mask = swav_optimizer(model, lr=1e-4, opt_over_trainable=True, **sched)
    state = init_state(model, cfg, opt, trainable_mask=mask)
    return state, make_full_step(model, cfg, opt, AugmentConfig(), trainable_mask=mask,
                                 opt_over_trainable=True, graphed=graphed)


def graphs_batch(dev, B: int):
    """B uint8 clips of 4 frames from the driver's synthetic bank (256
    buffers of 480 x 854 clips), their native sizes and gray means."""
    bank, gray = synthetic_clip_bank(DRIVER_BANK, 4, 256)
    idx = np.arange(B) % DRIVER_BANK
    return (torch.from_numpy(bank[idx]).to(dev),
            torch.tensor([DRIVER_NATIVE] * B, device=dev),
            torch.from_numpy(gray[idx]).to(dev))


def selection_extra(dev, B: int) -> dict:
    """Device ms (CUDA events, queued) of the augmentation's two per-clip
    selections at ``B`` clips of 4 frames (256 buffers): the contrast
    target (the buffer's gray mean) and the hue computed for every clip, as
    ``apply_augment`` does for fixed shapes, against the same for the clips
    that drew them alone (an index subset: shapes that follow the draws)."""
    from timetuning_tpu_torch.data import transforms as tf

    frames, _, _ = graphs_batch(dev, B)
    x = frames.float() / 255.0
    p = tf.draw_augment_params(torch.Generator().manual_seed(B), B, 4, tf.AugmentConfig())
    jit, op = p.column("jitter") > 0, p.column("op")
    c_idx = torch.nonzero(jit & (op == 1)).flatten().to(dev)
    h_idx = torch.nonzero(jit & (op == 3)).flatten().to(dev)
    hue = p.column("hue").to(dev)
    every = cuda_ms(lambda: (tf._pil_gray_mean(x), tf._adj_hue(x, hue.view(B, 1, 1, 1))),
                    reps=10)
    subset = cuda_ms(lambda: (tf._pil_gray_mean(x.index_select(0, c_idx)),
                              tf._adj_hue(x.index_select(0, h_idx),
                                          hue[h_idx].view(-1, 1, 1, 1))), reps=10)
    return {"every": every, "subset": subset, "n_contrast": int(c_idx.numel()),
            "n_hue": int(h_idx.numel())}


def run_graphs(dev) -> None:
    """The ``graphs`` phase's train part (the eval and serving programs are
    compared in their own phases): ``GRAPH_STEPS`` flagship steps at 32
    clips, default and forced (``attn_impl="pallas"``), graphed against
    eager from the same seed: the loss at every step, the launches of every
    step, then every parameter, teacher leaf, queue row and AdamW moment bit
    for bit; the step at 32 and 128 clips each way (ms, host ms, trace,
    peak memory); ``run_training`` at 32 clips for 2 epochs each way:
    clips/s over the window with and without the epoch-top save."""
    import functools
    import tempfile

    from timetuning_tpu_torch.core import train as ttrain
    from timetuning_tpu_torch.core.timet import state_tensors

    t_phase = time.perf_counter()
    for attn_impl in ("auto", "pallas"):
        label = "default" if attn_impl == "auto" else "forced"
        frames, sizes, gmeans = graphs_batch(dev, 32)
        runs, timing = {}, {}
        for mode in ("eager", "graphed"):
            state, step = graphs_step(dev, attn_impl, mode == "graphed")
            torch.cuda.reset_peak_memory_stats()
            losses, launches = [], []
            for i in range(GRAPH_STEPS):
                (state, m), n = call_launches(
                    lambda: step(state, frames, sizes, gmeans, ttrain.step_generator(1, i)))
                losses.append(float(m["loss"]))
                launches.append(n)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            runs[mode] = (losses, launches, {k: t.clone() for k, t in
                                             state_tensors(state).items()}, peak)
            if attn_impl == "auto":
                timing[mode] = {}
                for B in (32, 128):
                    xb = graphs_batch(dev, B)
                    gen = ttrain.step_generator(2, B)

                    def call():
                        return step(state, *xb, gen)

                    torch.cuda.reset_peak_memory_stats()
                    ms = cuda_ms(call, warmup=2, reps=5, queued=False)
                    timing[mode][B] = {
                        "call": call,
                        "ms": ms, "host_ms": host_ms(call),
                        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                        **trace(call, f"graphs train {label} B={B} {mode}", top=3)}
            del state, step
            torch.cuda.empty_cache()
        (le, ne, te, pe), (lg, ng, tg, pg) = runs["eager"], runs["graphed"]
        bad = [k for k in te if not torch.equal(te[k], tg[k])]
        print(f"graphs train {label} 32 clips, {GRAPH_STEPS} steps, queue ready at step 3, "
              f"cosine schedules over the steps: losses eager {le}, graphed {lg}; "
              f"launches a step {ne[-1]} (graphed {ng[-1]}); {len(te)} state tensors, "
              f"{len(bad)} differ; peak memory over the steps {pe:.3f} / {pg:.3f} GiB",
              flush=True)
        if le != lg or ne != ng or bad or te.keys() != tg.keys():
            raise AssertionError(f"graphs train {label}: graphed differs from eager "
                                 f"(losses {le} / {lg}, launches {ne} / {ng}, tensors "
                                 f"{bad[:5]})")
        for B in timing.get("graphed", {}):
            pair = {mode: timing[mode][B] for mode in ("eager", "graphed")}
            busy_check(f"train {label} B={B}", pair, pair["graphed"]["call"])
            e, g = pair["eager"], pair["graphed"]
            print(f"graphs train {label} step B={B} (augmentation + step): ms a step "
                  f"(CUDA events) eager {e['ms']:.3f}, graphed {g['ms']:.3f} = "
                  f"{B / e['ms'] * 1e3:.1f} / {B / g['ms'] * 1e3:.1f} clips/s; host ms "
                  f"a step {e['host_ms']:.3f} / {g['host_ms']:.3f}; device busy "
                  f"{e['busy_ms']:.3f} / {g['busy_ms']:.3f} ms, idle {pct(e['idle'])} "
                  f"/ {pct(g['idle'])}; peak memory {e['peak_gib']:.3f} / "
                  f"{g['peak_gib']:.3f} GiB", flush=True)

    for B in (32, 128):
        sel = selection_extra(dev, B)
        print(f"graphs augment selection B={B}: the gray mean and the hue of every clip "
              f"{sel['every']:.4f} ms against those of the clips that drew them "
              f"({sel['n_contrast']} contrast, {sel['n_hue']} hue) {sel['subset']:.4f} ms: "
              f"{sel['every'] - sel['subset']:.4f} ms more device time a step", flush=True)

    rates = {}
    make = ttrain.make_full_step
    for mode in ("eager", "graphed"):
        if mode == "eager":
            ttrain.make_full_step = functools.partial(make, graphed=False)
        try:
            with tempfile.TemporaryDirectory() as log_dir, step_times() as rec:
                out = ttrain.run_training(driver_config(dev, log_dir, 32))
        finally:
            ttrain.make_full_step = make
        if out["global_step"] != 8 or not np.isfinite(out["final_loss"]):
            raise AssertionError(f"graphs driver {mode}: {out['global_step']} steps, "
                                 f"final loss {out['final_loss']}")
        rates[mode] = driver_rates(rec, 32, per_epoch=4, skip=2)
    e, g = rates["eager"], rates["graphed"]
    print(f"graphs train driver B=32, 2 epochs of 4 steps (the first two steps left "
          f"out): clips/s over the window (the epoch-top save inside) eager "
          f"{e['window']:.1f}, graphed {g['window']:.1f}; inside an epoch "
          f"{e['in_epoch']:.1f} / {g['in_epoch']:.1f}; median ms a step "
          f"{e['median']:.3f} / {g['median']:.3f} (steps {e['gaps']} / {g['gaps']}) | "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)


def run_augment_card_vs_host(dev) -> None:
    """Phase 11: the same drawn values through ``apply_augment`` on the card
    and on the host (8 clips, 4 frames, 256 -> 224, native 480 x 854), TF32
    off: the products sum in another order; bound 1e-4 on the normalised
    output."""
    from timetuning_tpu_torch.data import transforms as tf

    cfg = tf.AugmentConfig()
    bank, gray = synthetic_clip_bank(DRIVER_BANK, 4, 256, seed=6)
    frames = torch.from_numpy(bank)
    sizes = torch.tensor([DRIVER_NATIVE] * DRIVER_BANK)
    gmeans = torch.from_numpy(gray)
    params = tf.draw_augment_params(torch.Generator().manual_seed(3), DRIVER_BANK, 4, cfg)
    want, _ = tf.apply_augment(frames, params, cfg, sizes, gmeans)
    got, _ = tf.apply_augment(frames.to(dev), params, cfg, sizes.to(dev), gmeans.to(dev))
    err = (got.cpu() - want).abs().max().item()
    ops = params.column("op")[params.column("jitter") > 0].long().tolist()
    print(f"train augment, card vs host, {DRIVER_BANK} clips (jitter ops {ops}, "
          f"blur {params.column('blur').long().tolist()}): max_abs_err {err:.3e} "
          f"(bound 1e-4)", flush=True)
    if not (got.is_cuda and err <= 1e-4):
        raise AssertionError("the augmentation on the card disagrees with the host's")


def synthetic_pascal_batches(n_batches: int = 2, n: int = EVAL_BATCH, size: int = S,
                             mask_size: int = 112, seed: int = 7):
    """Pascal-VOC-like batches as ``data/pascal.pascal_loader`` yields them
    for the in-training eval: uint8 images [n, 224, 224, 3] of up to two
    coloured boxes of a class colour on a gradient with noise, masks
    [n, 112, 112] with the boxes' classes (1-20), background 0 and a 255
    border."""
    rng = np.random.default_rng(seed)
    colors = rng.integers(0, 256, (21, 3))
    yy, xx = np.mgrid[0:size, 0:size] / size
    out = []
    for _ in range(n_batches):
        imgs = np.empty((n, size, size, 3), np.uint8)
        masks = np.zeros((n, mask_size, mask_size), np.uint8)
        for i in range(n):
            a, b = rng.uniform(30, 120, (2, 3))
            img = a * yy[..., None] + b * xx[..., None] + rng.normal(0, 8, (size, size, 3))
            for _box in range(int(rng.integers(1, 3))):
                cls = int(rng.integers(1, 21))
                y, x = (int(v) for v in rng.integers(0, size - 80, 2))
                h, w = (int(v) for v in rng.integers(48, 80, 2))
                img[y:y + h, x:x + w] = colors[cls] + rng.normal(0, 8, (h, w, 3))
                r = mask_size / size
                masks[i, int(y * r):int((y + h) * r), int(x * r):int((x + w) * r)] = cls
            imgs[i] = np.clip(img, 0, 255).astype(np.uint8)
        masks[:, :2] = masks[:, -2:] = 255
        out.append((imgs, masks))
    return out


def check_eval_features(dev, model, feature_fn, images) -> None:
    """The in-training eval's feature function on one batch (K4 at 224 ->
    224, then K1 and K2 in each of the 12 blocks) against the plain
    preprocess and the plain blocks on the same model and images, both on
    the card; the plain forward must launch no kernel. Bound: per-token
    cosine >= 0.999 (bf16 rounding accumulated over 12 blocks, as
    ``check_vit``)."""
    from timetuning_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
    from timetuning_tpu_torch.ops import kernel_lib
    from timetuning_tpu_torch.ops import preprocess_cuda as pc

    x = torch.from_numpy(images).to(dev)
    got = feature_fn(x)[0].float()
    torch.cuda.synchronize()
    kernel_lib.reset_launch_counts()
    with torch.no_grad():
        plain = pc.eval_preprocess_plain(x, S, IMAGENET_MEAN, IMAGENET_STD)
        want = model(plain, use_head=False, attn_impl="xla")[0].float()
    torch.cuda.synchronize()
    launched = {k: v for k, v in kernel_lib.launch_counts().items() if v}
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    print(f"eval driver features ({images.shape[0]} images {list(images.shape[1:])} "
          f"u8, feature function against plain preprocess + plain blocks): "
          f"{list(got.shape)}, min per-token cosine {cos.min().item():.6f} "
          f"(bound >= 0.999), max_abs_err {(got - want).abs().max().item():.3e}",
          flush=True)
    if launched:
        raise AssertionError(f"eval driver: the plain forward launched {launched}")
    if not torch.isfinite(got).all() or cos.min().item() < 0.999:
        raise AssertionError("eval driver: the feature function disagrees with "
                             "the plain preprocess and blocks")


def run_eval_driver(dev, totals: dict) -> None:
    """Phase 12: the in-training Pascal eval as ``core/train.run_training``
    runs it (``make_eval_feature_fn`` + ``Evaluator``) at dino-s16 224, bf16,
    eval resolution 112, 21 clusters, on 120 synthetic images in batches of
    60: the dataset-wise protocol in memory and streaming. Before the timed
    passes, at the batch of 60 (so that their graphs are captured outside
    them): the feature function with and without the attention and the
    diagnostics' scores function, each graphed against its eager path
    (``graphs_compare``)."""
    from timetuning_tpu_torch.core.train import (
        build_model,
        make_diagnostics_scores_fn,
        make_eval_feature_fn,
    )
    from timetuning_tpu_torch.eval.evaluator import Evaluator
    from timetuning_tpu_torch.ops import kmeans as km

    cfg = driver_config(dev, "unused", 32)
    model, _, res = build_model(cfg, dev)
    feature_fn = make_eval_feature_fn(model, cfg.input_resolution)
    batches = synthetic_pascal_batches()
    kmeans_ms = []
    fit = km.kmeans

    def timed_kmeans(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fit(*a, **kw)
        torch.cuda.synchronize()
        kmeans_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    km.kmeans = timed_kmeans
    try:
        # warm-up: the forward, and the native matcher's one-time build
        # (a fresh checkout has none) outside the timed passes
        from timetuning_tpu_torch import native

        t0 = time.perf_counter()
        native.hungarian(np.eye(3))
        print(f"eval driver: native matcher ready in {time.perf_counter() - t0:.2f} s "
              f"(built on first use where the checkout has no build)", flush=True)
        feature_fn(batches[0][0][:2])
        x = torch.from_numpy(batches[0][0]).to(dev)
        eager_fn = make_eval_feature_fn(model, cfg.input_resolution, graphed=False)
        for want_attention in (False, True):
            graphs_compare(f"eval driver features want_attention={want_attention}",
                           feature_fn, eager_fn, x, want_attention)
        graphs_compare("eval driver diagnostics scores",
                       make_diagnostics_scores_fn(model, cfg.input_resolution),
                       make_diagnostics_scores_fn(model, cfg.input_resolution,
                                                  graphed=False), x)
        check_eval_features(dev, model, feature_fn, batches[0][0])
        # the in-memory pass twice: k-means (~2,000 launches, a host sync in
        # each bincount) is host-bound, so its time moves from call to call
        for label, streaming in (("in memory", False), ("in memory, again", False),
                                 ("streaming", True)):
            ev = Evaluator(lambda: iter(batches), feature_fn, res, num_classes=21,
                           involve_bg=True, ignore_index=255)
            kmeans_ms.clear()
            t0 = time.perf_counter()
            score, counts = counted(("eval", "pascal"), lambda: ev.evaluate(
                evaluation_protocol="dataset-wise", eval_resolution=112,
                num_clusters=21, streaming=streaming), totals)
            ms = (time.perf_counter() - t0) * 1e3
            print(f"eval driver ({label}, dataset-wise, 120 images, k=21 at 112): "
                  f"mIoU {score:.6f} | {ms:.1f} ms, of it k-means {sum(kmeans_ms):.1f} ms "
                  f"({len(kmeans_ms)} fit) | launches {counts}", flush=True)
            if not (np.isfinite(score) and 0.0 <= score <= 1.0):
                raise AssertionError(f"eval driver: mIoU {score} is not in [0, 1]")
            passes = 2 if streaming else 1
            want = {"preprocess": 2 * passes, "attention_block": 24 * passes,
                    "mlp_block": 24 * passes}
            if {k: counts[k] for k in want} != want:
                raise AssertionError(f"eval driver: launches {counts}, expected {want}")
    finally:
        km.kmeans = fit


def zoo_frames(n: int | None = None, seed: int = 11) -> np.ndarray:
    """``n`` (default ``ZOO_FRAMES``) uint8 DAVIS-size frames [n, 480, 854,
    3]: noise and a textured box, so the features vary from patch to
    patch."""
    n = ZOO_FRAMES if n is None else n
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 60, (n, H, W, 3), dtype=np.uint8)
    tex = rng.integers(100, 256, (160, 220, 3), dtype=np.uint8)
    for t in range(n):
        frames[t, 100 + 8 * t:260 + 8 * t, 200 + 12 * t:420 + 12 * t] = tex
    return frames


def zoo_path_kernels(name: str, dtype: torch.dtype) -> tuple:
    """The kernels the zoo's feature path must launch for ``name``: in bf16
    the preprocess (uint8 shrunk to bf16) and, for the ViTs whose blocks the
    kernels take, the two block kernels (at 785 tokens K1 runs its core's
    two passes); the test ViTs and MAE run the plain blocks and the CNNs
    have none, as in JAX; f32 launches nothing."""
    from timetuning_tpu_torch.models.registry import VIT_NAMES

    if dtype != torch.bfloat16:
        return ()
    if name in VIT_NAMES[2:] or name == "stego":
        return ("preprocess", "attention_block", "mlp_block")
    return ("preprocess",)


def run_zoo(dev, totals: dict) -> None:
    """Every name of the registry, at full width with seeded weights, on the
    eval feature path (uint8 frames -> ``eval_preprocess_batch`` -> the
    backbone) for 8 DAVIS-size frames at 224, in bf16 and in f32. ViTs (and
    STEGO, MAE): the bf16 tokens against the f32 plain forward on the card
    (the same weights; f32 launches no kernel at 785 tokens or fewer),
    per-token cosine >= 0.999. CNNs: the f32 tokens on the card against the
    host's on 2 frames (TF32 off in convolutions too), within 1e-4 of the
    output's scale. ms a frame and launches for each."""
    from timetuning_tpu_torch.data.transforms import eval_preprocess_batch
    from timetuning_tpu_torch.models.registry import ARCHITECTURES, VIT_NAMES, get_backbone

    frames = torch.from_numpy(zoo_frames()).to(dev)
    cnns = ("resnet18", "resnet50", "swav", "dul", "motion_grouping")
    for name in ARCHITECTURES:
        feats, ms = {}, {}
        for dtype in (torch.bfloat16, torch.float32):
            bb = get_backbone(name, dtype=dtype, device=dev)

            def fwd(x=frames, bb=bb, dtype=dtype):
                with torch.inference_mode():
                    return bb.apply(eval_preprocess_batch(x, out_size=S,
                                                          compute_dtype=dtype))[0]

            fwd()
            PATH_KERNELS[("zoo", name, str(dtype))] = zoo_path_kernels(name, dtype)
            out, counts = counted(("zoo", name, str(dtype)), fwd, totals)
            if name == "mae" or name in VIT_NAMES[:2] or name in cnns:
                blocks = {k: counts[k] for k in ("attention_block", "mlp_block", "mha")}
                if any(blocks.values()):
                    raise AssertionError(f"zoo {name}: launched block kernels {blocks}")
            ms[dtype] = cuda_ms(fwd, warmup=1, reps=3, queued=False) / ZOO_FRAMES
            feats[dtype] = out.float()
            launched = {k: v for k, v in counts.items() if v}
            print(f"zoo {name} {str(dtype)[6:]}: tokens {list(out.shape)}, "
                  f"{ms[dtype]:.3f} ms a frame, launches {launched}", flush=True)
            if not torch.isfinite(feats[dtype]).all():
                raise AssertionError(f"zoo {name} {dtype}: non-finite tokens")
            if name in cnns and dtype == torch.float32:
                host = get_backbone(name, dtype=dtype, device="cpu")
                with torch.inference_mode():
                    want = host.apply(eval_preprocess_batch(frames[:2].cpu(), out_size=S))[0]
                err = (out[:2].cpu() - want).abs().max().item()
                scale = want.abs().max().item()
                print(f"zoo {name} f32 card vs host (2 frames): max_abs_err {err:.3e} "
                      f"of scale {scale:.3e} (bound 1e-4 of it)", flush=True)
                if err > 1e-4 * scale:
                    raise AssertionError(f"zoo {name}: card disagrees with host")
            del bb
        if name not in cnns:
            cos = torch.nn.functional.cosine_similarity(
                feats[torch.bfloat16], feats[torch.float32], dim=-1)
            print(f"zoo {name}: bf16 against the f32 plain forward, min per-token "
                  f"cosine {cos.min().item():.6f} (bound >= 0.999)", flush=True)
            if cos.min().item() < 0.999:
                raise AssertionError(f"zoo {name}: bf16 forward disagrees with plain")


def write_pascal_tree(root: str, n_train: int = 128, n_val: int = 64,
                      seed: int = 13) -> None:
    """A synthetic Pascal VOC tree in the loader's layout (``images/``,
    ``SegmentationClass[Aug]/``, ``sets/{trainaug,val}.txt``): 500 x 375
    images of one or two class-coloured boxes on a noisy gradient, masks
    with the boxes' classes and a 255 band around each box."""
    import cv2

    rng = np.random.default_rng(seed)
    colors = rng.integers(0, 256, (21, 3))
    for sub in ("images", "SegmentationClass", "SegmentationClassAug", "sets"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    h, w = 375, 500
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    names = [f"{i:06d}" for i in range(n_train + n_val)]
    for n in names:
        a, b = rng.uniform(30, 120, (2, 3))
        img = a * yy[..., None] + b * xx[..., None] + rng.normal(0, 8, (h, w, 3))
        mask = np.zeros((h, w), np.uint8)
        for _ in range(int(rng.integers(1, 3))):
            cls = int(rng.integers(1, 21))
            y, x = int(rng.integers(0, h - 150)), int(rng.integers(0, w - 180))
            bh, bw = int(rng.integers(90, 150)), int(rng.integers(110, 180))
            mask[max(y - 3, 0):y + bh + 3, max(x - 3, 0):x + bw + 3] = 255
            img[y:y + bh, x:x + bw] = colors[cls] + rng.normal(0, 8, (bh, bw, 3))
            mask[y:y + bh, x:x + bw] = cls
        cv2.imwrite(os.path.join(root, "images", f"{n}.jpg"),
                    np.clip(img, 0, 255).astype(np.uint8)[..., ::-1])
        for sub in ("SegmentationClass", "SegmentationClassAug"):
            cv2.imwrite(os.path.join(root, sub, f"{n}.png"), mask)
    with open(os.path.join(root, "sets", "trainaug.txt"), "w") as f:
        f.write("\n".join(names[:n_train]))
    with open(os.path.join(root, "sets", "val.txt"), "w") as f:
        f.write("\n".join(names[n_train:]))


@contextlib.contextmanager
def stage_times(patches):
    """While the block runs, each (owner, attribute, stage) of ``patches`` is
    wrapped so that its calls add their host-clock ms, the card drained
    before and after, to the yielded dict's ``stage``."""
    times: dict = {}

    def wrap(fn, stage):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                times[stage] = times.get(stage, 0.0) + (time.perf_counter() - t0) * 1e3
        return run

    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patches]
    for owner, attr, stage in patches:
        setattr(owner, attr, wrap(getattr(owner, attr), stage))
    try:
        yield times
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def run_cbfe(dev, totals: dict) -> None:
    """``cli/cbfe.run_cbfe`` at its defaults (dino-s16, input 448: 785 tokens,
    k = 300 at resolution 100, 21 eval clusters, f32, batches of 32) on a
    synthetic Pascal tree of 128 trainaug and 64 val images through the real
    ``pascal_loader``: the five numbers, each stage's ms and the peak
    memory. f32 as in JAX: the path launches no kernel. Before it, the
    feature function on one batch on the card against the host's (cosine
    >= 0.9999), and ``evaluate_bf_score`` on the card against the host's on
    the same masks."""
    import tempfile

    from timetuning_tpu_torch.cli import cbfe
    from timetuning_tpu_torch.data.pascal import pascal_loader
    from timetuning_tpu_torch.eval import cbfe as ecbfe
    from timetuning_tpu_torch.eval.bfscore import evaluate_bf_score
    from timetuning_tpu_torch.eval.evaluator import Evaluator
    from timetuning_tpu_torch.models.registry import get_backbone

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_pascal_tree(root)
        print(f"cbfe: synthetic Pascal tree (128 trainaug, 64 val, 500 x 375) "
              f"written in {time.perf_counter() - t0:.1f} s", flush=True)
        args = cbfe.build_parser().parse_args(["--pascal_root", root, "--device", dev.type])

        imgs, masks = next(iter(pascal_loader(4, root, "val", args.resolution,
                                              args.input_resolution)))
        got = cbfe.make_feature_fn(get_backbone(args.architecture, device=dev),
                                   args.input_resolution, dev)(imgs)
        want = cbfe.make_feature_fn(get_backbone(args.architecture, device="cpu"),
                                    args.input_resolution, "cpu")(imgs)
        cos = torch.nn.functional.cosine_similarity(got[0].cpu(), want[0], dim=-1)
        same_fg = (got[1].cpu() == want[1]).float().mean().item()
        print(f"cbfe features (4 val images at {args.input_resolution}, card vs host, "
              f"f32): {list(got[0].shape)}, min per-token cosine {cos.min().item():.6f} "
              f"(bound >= 0.9999), attention masks equal at {same_fg:.4f} of pixels",
              flush=True)
        if cos.min().item() < 0.9999:
            raise AssertionError("cbfe: the feature function disagrees with the host's")
        gt = torch.from_numpy(np.stack([m > 0 for m in masks]))
        fg = torch.nn.functional.interpolate(
            got[1][:, None].float(), size=gt.shape[-2:])[:, 0].cpu() > 0.5
        bf_card = evaluate_bf_score(gt.to(dev), fg.to(dev))
        bf_host = evaluate_bf_score(gt.numpy(), fg.numpy())
        print(f"cbfe boundary F on the card {bf_card:.6f}, on the host {bf_host:.6f}",
              flush=True)
        if abs(bf_card - bf_host) > 1e-6:
            raise AssertionError("cbfe: evaluate_bf_score differs between card and host")

        stages = [(ecbfe.ClusterBasedForegroundExtraction, "_collect", "features"),
                  (ecbfe, "overcluster", "overcluster")]
        stages += [(ecbfe, fn, "sweep") for fn in (
            "cluster_precisions", "find_good_threshold", "masks_from_threshold")]
        stages += [(ecbfe, "evaluate_bf_score", "bf"), (Evaluator, "evaluate", "evaluator")]
        torch.cuda.reset_peak_memory_stats()
        with stage_times(stages) as timings:
            t0 = time.perf_counter()
            res, counts = counted(("cbfe", "float32"),
                                  lambda: cbfe.run_cbfe(args, log=lambda m: None), totals)
            wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launched = {k: v for k, v in counts.items() if v}
    print(f"cbfe dino-s16/448 f32 (128 + 64 images, k=300 at 100, 21 eval clusters): "
          f"threshold={res['threshold']} train_j={res['train_jaccard']:.6f} "
          f"val_j={res['val_jaccard']:.6f} val_bf={res['val_bf']:.6f} "
          f"masked_miou={res['masked_miou']:.6f} | {wall * 1e3:.1f} ms: "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in timings.items())
          + f" | peak memory {peak:.2f} GiB | launches {launched}", flush=True)
    if launched:
        raise AssertionError(f"cbfe: the f32 path launched kernels {launched}")
    vals = [res[k] for k in ("threshold", "train_jaccard", "val_jaccard", "val_bf",
                             "masked_miou")]
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals):
        raise AssertionError(f"cbfe: results outside [0, 1]: {res}")
    if abs(res["threshold"] * 20 - round(res["threshold"] * 20)) > 1e-9:
        raise AssertionError(f"cbfe: threshold {res['threshold']} is not on the 0.05 grid")


def run_propagate_flow(dev, totals: dict) -> None:
    """``cli/propagate --use_optical_flow`` on the two synthetic clips:
    OpenCV's Farneback flow on the host, no backbone forward; J&F and ms."""
    from timetuning_tpu_torch.cli import propagate as prop
    from timetuning_tpu_torch.models.registry import get_backbone

    args = prop.build_parser().parse_args(["--use_optical_flow", "true"])
    clips = synthetic_clips(textured=True)
    bb = get_backbone(args.architecture, device=dev)
    t0 = time.perf_counter()
    res, counts = counted(("propagate", "flow"),
                          lambda: prop.evaluate_clips(args, bb, clips, dev), totals)
    ms = (time.perf_counter() - t0) * 1e3
    jf = res["jf"]
    print(f"propagate flow (2 clips of 25 frames at {S}): J={jf['J']:.6f} "
          f"F={jf['F']:.6f} J&F={jf['J&F']:.6f} | {ms:.1f} ms | launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in jf.values()):
        raise AssertionError(f"propagate flow: scores {jf}")


def check_heads32(dev, results: dict, totals: dict) -> None:
    """Heads of 32 (MoCo-v3 ViT-S/16's twelve) in the cores that took only
    64 before: kernels 5/6 in bf16 and f32 at 4 frames x 12 heads, Sk 1,025
    and 3,137 with a key mask (kv_len = Sk - 17), kernel 10 in f32 at 8 x 12
    x 197 and 785; then ``mocov3-s16`` at 576 px (1,297 tokens: the row
    kernels and the flash core) through the registry, bf16 against the f32
    forward. Inputs from a generator of their own."""
    from timetuning_tpu_torch.models.registry import get_backbone
    from timetuning_tpu_torch.ops import attention as at
    from timetuning_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(3232)
    t, _ = _tensor_maker(dev, rng)
    report = _reporter(results)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    tols = {torch.bfloat16: (4e-3, 1e-2, "atol=4e-3 rtol=1e-2 (one bf16 ulp of the "
                             "output, p rounds to bf16 against another max)"),
            torch.float32: (1e-5, 1e-4, "atol=1e-5 rtol=1e-4 (f32 sums in another "
                            "order)")}
    for s_k in (1025, 3137):
        base = [rng.standard_normal((4, 12, s_k, 32)) for _ in range(3)]
        kv_len = s_k - 17
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t(a, dtype) for a in base)
            kind = "bf16" if dtype == torch.bfloat16 else "f32"
            key = f"flash_attention/{kind}/{s_k}/h32"
            got = fa.flash_attention(q, k, v, kv_len=kv_len)
            want = fa.flash_attention_xla(q, k, v, kv_len=kv_len)
            torch.cuda.synchronize()
            atol, rtol, tol = tols[dtype]
            ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
            n_exp = float(4 * 12 * s_k * kv_len)
            report("flash_attention", got, want, tol,
                   cuda_ms(lambda: fa.flash_attention(q, k, v, kv_len=kv_len)),
                   cuda_ms(lambda: fa.flash_attention_xla(q, k, v, kv_len=kv_len),
                           warmup=1, reps=3),
                   extra=f"{kind} [4 x 12, {s_k}, 32] kv_len={kv_len} ", key=key,
                   work=(io_bytes(q, k[:, :, :kv_len], v[:, :, :kv_len], got),
                         4.0 * n_exp * 32, kind),
                   library_ms=cuda_ms(lambda: sdpa(q, k[:, :, :kv_len], v[:, :, :kv_len])))
            exp_line(key, n_exp, results[key]["bound_ms"])
            if not ok:
                raise AssertionError(f"{key}: kernel disagrees with plain version")
            del q, k, v, got, want
    for s_tok in (197, 785):
        qkv = t(rng.standard_normal((8, s_tok, 3, 12, 32)))
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        got = at.attention_mha(q, k, v)
        want = at.attention_mha_plain(q, k, v)
        torch.cuda.synchronize()
        atol, rtol, tol = tols[torch.float32]
        ok = torch.allclose(got, want, atol=atol, rtol=rtol)
        key = f"mha/f32/{s_tok}/h32"
        n_exp = float(8 * 12 * s_tok * s_tok)
        report("mha", got, want, tol, cuda_ms(lambda: at.attention_mha(q, k, v)),
               cuda_ms(lambda: at.attention_mha_plain(q, k, v), warmup=1, reps=5),
               extra=f"f32 [8 x 12, {s_tok}, 32] passes {at.mha_plan(s_tok)[0]} ", key=key,
               work=(io_bytes(q, k, v, got), 4.0 * n_exp * 32, "f32"),
               library_ms=cuda_ms(lambda: sdpa(q, k, v)))
        exp_line(key, n_exp, results[key]["bound_ms"])
        if not ok:
            raise AssertionError(f"{key}: kernel disagrees with plain version")
        del qkv, q, k, v, got, want

    # MoCo-v3 ViT-S/16 above 512 px: 36 x 36 patches, 1,297 tokens
    size = 576
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, size, size, 3)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        f32 = get_backbone("mocov3-s16", dtype=torch.float32, device=dev).module(x)[
            "tokens"].float()
        bb = get_backbone("mocov3-s16", dtype=torch.bfloat16, device=dev)
        out, counts = counted(("heads32", "mocov3-s16"),
                              lambda: bb.module(x)["tokens"].float(), totals)
    cos = torch.nn.functional.cosine_similarity(out, f32, dim=-1)
    print(f"heads32 mocov3-s16 at {size}, {out.shape[1]} tokens, 12 heads of 32: bf16 "
          f"(kernels) against f32: min per-token cosine {cos.min().item():.6f} (bound "
          f">= 0.999) | launches {counts}", flush=True)
    if not torch.isfinite(out).all() or cos.min().item() < 0.999:
        raise AssertionError("mocov3-s16 at 576 px: bf16 disagrees with f32")


def check_grad(dev, results: dict) -> None:
    """The backward of the kernels JAX differentiates through, on the card:
    for K1 and K2 at 50 x 197 tokens and K7, K8, K9 and K5/6 at 4 x 3,137,
    the gradients of every input through the kernel's autograd Function
    (the kernel forward, JAX's backward: the plain version's VJP, or the
    flash core's streamed analytic gradient) against autograd through the
    plain version; fwd + bwd ms of both. Bound: 2 % of the largest gradient
    of the input (the backward runs in f32 from bf16 inputs; the plain
    version's autograd rounds the probabilities' gradient to bf16 where the
    flash backward does not)."""
    from timetuning_tpu_torch.ops import flash_attention as fa
    from timetuning_tpu_torch.ops import fused_block as fb

    rng = np.random.default_rng(77)
    t, w = _tensor_maker(dev, rng)
    D, Hd = 384, 1536
    T8 = (S8 // 8) ** 2 + 1

    def vec(n, base=0.0):
        return t(base + 0.1 * rng.standard_normal(n))

    ln = (vec(D, 1.0), vec(D))
    attn = (*ln, w(D, 3 * D), vec(3 * D), w(D, D), vec(D))
    mlp = (*ln, w(D, Hd), vec(Hd), w(Hd, D), vec(D))
    x197 = t(rng.standard_normal((CLIPS * FRAMES, 197, D)), torch.bfloat16)
    xr = t(rng.standard_normal((4, T8, D)), torch.bfloat16)
    q, k, v = (t(rng.standard_normal((4, 6, T8, 64)), torch.bfloat16) for _ in range(3))
    cases = (
        ("attention_block", fb.attention_block_branch, fb.attention_block_xla,
         (x197, *attn, 6)),
        ("mlp_block", fb.mlp_block_branch, fb.mlp_block_xla, (x197, *mlp)),
        ("ln_dense", fb.ln_dense_rows, fb.ln_dense_xla, (xr, *attn[:4])),
        ("dense_residual", fb.dense_residual_rows, fb.dense_residual_xla,
         (xr, xr, attn[4], attn[5])),
        ("mlp_rows", fb.mlp_rows, fb.mlp_block_xla, (xr, *mlp)),
        ("flash_attention", fa.flash_attention, fa.flash_attention_xla, (q, k, v)),
    )
    for name, kern, plain, args in cases:
        def grads(fn):
            leaves = [a.detach().clone().requires_grad_(True) if torch.is_tensor(a) else a
                      for a in args]
            out = fn(*leaves)
            g = torch.ones_like(out) / out.numel() ** 0.5
            return torch.autograd.grad(out, [a for a in leaves if torch.is_tensor(a)], g)

        got, want = grads(kern), grads(plain)
        torch.cuda.synchronize()
        errs, ok = [], True
        for a, b in zip(got, want):
            scale = b.float().abs().max().item()
            err = (a.float() - b.float()).abs().max().item()
            errs.append(err / max(scale, 1e-30))
            ok = ok and bool(torch.isfinite(a).all()) and err <= 2e-2 * scale
        ms = cuda_ms(lambda: grads(kern), warmup=1, reps=3, queued=False)
        plain_ms = cuda_ms(lambda: grads(plain), warmup=1, reps=3, queued=False)
        shape = "x".join(str(d) for d in args[0].shape)
        print(f"grad {name} [{shape}] bf16: {len(got)} inputs, max |Δ| / max |grad| "
              f"{max(errs):.3e} (bound 2e-2) | fwd + bwd through the kernel's Function "
              f"{ms:.3f} ms, through the plain version {plain_ms:.3f} ms", flush=True)
        if not ok:
            raise AssertionError(f"grad {name}: the Function's gradients disagree with "
                                 "autograd through the plain version")
        del got, want


def run_train_grad_paths(dev, totals: dict, default: dict) -> None:
    """The flagship step with ``TimeTConfig(grad_attn_impl=None)``: the
    differentiated pass through the block kernels and their backward (16
    launches of K1 and K2 a step instead of 14); its first loss within 2e-3
    of the default step's (relative, the forced step's gate). Then the same
    step with ``ViTConfig.remat``: the same loss, the grad path's blocks run
    again in the backward (2 launches more of K1 and K2), and the peak
    memory of both."""
    clip = synthetic_train_clips(TRAIN_B, dev)
    probe = "feature_extractor.backbone.blocks.10.attn.qkv.weight"
    got = {}
    for label, remat in (("kernels on the grad path", False),
                         ("kernels on the grad path, remat", True)):
        model, cfg, mask, state, step = build_train(dev, torch.bfloat16, remat=remat,
                                                    grad_attn_impl=None)
        before = dict(model.named_parameters())[probe].detach().clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (_, metrics), counts = counted(("train", label), lambda: step(state, clip), totals)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        update = dict(model.named_parameters())[probe].detach() - before
        got[remat] = (float(metrics["loss"]), update)
        want = 18 if remat else 16
        print(f"train {label} B={TRAIN_B} bf16: loss {got[remat][0]:.6f} (default "
              f"{default['loss']:.6f}), peak memory {peak:.3f} GiB | launches {counts}",
              flush=True)
        if counts["attention_block"] != want or counts["mlp_block"] != want:
            raise AssertionError(f"train {label}: K1/K2 launched {counts['attention_block']}"
                                 f"/{counts['mlp_block']} times, expected {want}")
        del model, state, step
    rel = abs(got[False][0] - default["loss"]) / default["loss"]
    agree = float((torch.sign(got[False][1]) == torch.sign(default["update"][probe]))
                  .float().mean())
    remat_agree = float((torch.sign(got[True][1]) == torch.sign(got[False][1])).float().mean())
    print(f"train kernels on the grad path vs default, step 1: loss relative "
          f"{rel:.3e} (gate 2e-3), block 10 qkv update sign agreement {agree:.4f} | "
          f"remat: loss {got[True][0]:.6f} vs {got[False][0]:.6f} (gate: equal), update "
          f"sign agreement {remat_agree:.4f}", flush=True)
    if not np.isfinite(got[False][0]) or rel > 2e-3:
        raise AssertionError("the step with the kernels on the grad path disagrees with "
                             "the default one")
    if got[True][0] != got[False][0] or remat_agree < 0.99:
        raise AssertionError("remat changed the step")


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn``, no synchronise in the loop (best
    of 5 rounds of ``calls``)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return best * 1e6


def run_export(dev, totals: dict) -> None:
    """``cli/export``: the serving program of ``dino-s16`` at 224 in bf16,
    batch 64, written by ``cli/export.main`` and loaded with
    ``load_exported``; export s, MB, the round trip against the live forward
    (gate max |Δ| <= 1e-3), frames/s of both (CUDA events, after warm-up),
    and one call of the program launching exactly the preprocess once and
    K1 and K2 twelve times. Then the symbolic-batch program (called at 65
    and at 7) and ``dino-s8`` at 448, batch 4 (the row kernels and the flash
    core). Before it: K1's host us a call on the eager path through the
    direct wrapper (before the custom ops), through ``kernel_entry`` (now)
    and through the custom op (what a loaded program calls)."""
    import tempfile

    from timetuning_tpu_torch.cli import export as cli_export
    from timetuning_tpu_torch.models.registry import get_backbone
    from timetuning_tpu_torch.ops import fused_block as fb

    t, w = _tensor_maker(dev, np.random.default_rng(16))
    D = 384
    x = t(np.random.default_rng(17).standard_normal((1, 16, D)), torch.bfloat16)
    attn = (t(np.ones(D)), t(np.zeros(D)), w(D, 3 * D), t(np.zeros(3 * D)), w(D, D),
            t(np.zeros(D)), 6)
    entry = fb.attention_block_branch
    us = {name: host_us(lambda f=f: f(x, *attn))
          for name, f in (("direct", entry.kernel), ("entry", entry), ("op", entry.op))}
    print(f"host us a call of K1 at [1, 16, {D}], no synchronise: eager before this "
          f"port's custom ops (the wrapper, direct) {us['direct']:.1f}, eager now "
          f"(kernel_entry) {us['entry']:.1f}, the custom op (a loaded program's call) "
          f"{us['op']:.1f}", flush=True)

    want_counts = {"dino-s16": {"preprocess": 1, "attention_block": 12, "mlp_block": 12},
                   "dino-s8": {"preprocess": 1, "ln_dense": 12, "flash_attention": 12,
                               "dense_residual": 12, "mlp_rows": 12}}
    with tempfile.TemporaryDirectory() as tmp:
        for arch, size, batch, symbolic in (("dino-s16", S, 64, False),
                                            ("dino-s16", S, 64, True),
                                            ("dino-s8", S8, 4, False)):
            label = arch + (" symbolic" if symbolic else "")
            out = os.path.join(tmp, f"{arch}-{int(symbolic)}.pt2")
            t0 = time.perf_counter()
            rc = cli_export.main(["--architecture", arch, "--input_resolution", str(size),
                                  "--batch_size", str(batch), "--out", out,
                                  "--check", "false", "--device", dev.type,
                                  "--symbolic_batch", str(symbolic).lower()])
            export_s = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"export {label}: cli/export.main returned {rc}")
            fn = cli_export.load_exported(out)
            live = cli_export.FeatureForward(
                get_backbone(arch, dtype=torch.bfloat16, device=dev), size,
                torch.bfloat16).eval()
            frames = torch.from_numpy(np.random.default_rng(0).integers(
                0, 256, (batch, size, size, 3), np.uint8)).to(dev)
            with torch.no_grad():
                (got,), counts = counted(("export", label), lambda: (fn(frames),), totals)
                want = live(frames)
                err = (got.float() - want.float()).abs().max().item()
                launched = {k: n for k, n in counts.items() if n}
                prog_ms = cuda_ms(lambda: fn(frames), warmup=2, reps=5, queued=False)
                live_ms = cuda_ms(lambda: live(frames), warmup=2, reps=5, queued=False)
                if not symbolic:
                    prog_us = host_us(lambda: fn(frames), calls=3)
                    live_us = host_us(lambda: live(frames), calls=3)
                    print(f"export {label}: host ms a call, no synchronise: program "
                          f"{prog_us / 1e3:.3f}, live forward {live_us / 1e3:.3f}",
                          flush=True)
                    trace(lambda: fn(frames), f"export {label} program")
                    trace(lambda: live(frames), f"export {label} live forward")
                extra = ""
                if symbolic:
                    for b in (65, 7):
                        xb = torch.from_numpy(np.random.default_rng(b).integers(
                            0, 256, (b, size, size, 3), np.uint8)).to(dev)
                        gb, wb = fn(xb), live(xb)
                        eb = (gb.float() - wb.float()).abs().max().item()
                        extra += f", batch {b}: features {tuple(gb.shape)} max|Δ| {eb:.2e}"
                        if gb.shape[0] != b or eb > 1e-3:
                            raise AssertionError(f"export {label}: batch {b} fails")
            print(f"export {label} at {size} bf16 batch {batch}: export "
                  f"{export_s:.2f} s, program {os.path.getsize(out) / 1e6:.1f} MB, "
                  f"round trip max|Δ| {err:.2e} (gate 1e-3), program "
                  f"{batch / prog_ms * 1e3:.1f} frames/s ({prog_ms:.3f} ms), live forward "
                  f"{batch / live_ms * 1e3:.1f} frames/s ({live_ms:.3f} ms) | one call's "
                  f"launches {launched}{extra}", flush=True)
            if err > 1e-3 or not torch.isfinite(got).all():
                raise AssertionError(f"export {label}: the program disagrees with the "
                                     "live forward")
            if launched != want_counts[arch]:
                raise AssertionError(f"export {label}: one call launched {launched}, "
                                     f"expected {want_counts[arch]}")
            eager = cli_export.load_exported(out, graphed=False)
            with torch.no_grad():
                for xb in [frames] + ([torch.from_numpy(np.random.default_rng(b).integers(
                        0, 256, (b, size, size, 3), np.uint8)).to(dev) for b in (65, 7)]
                        if symbolic else []):
                    graphs_compare(f"export {label} batch {xb.shape[0]}", fn, eager, xb)
            del fn, eager, live, frames, got, want


def write_davis_tree(root: str) -> None:
    """The two synthetic 25-frame 480 x 854 clips (textured box) as a DAVIS
    tree: ``JPEGImages/480p/<video>/%05d.jpg`` and the box's annotation in
    ``Annotations/480p/<video>/%05d.png``."""
    import cv2

    for v, (frames, annots) in enumerate(synthetic_clips(textured=True)):
        fdir = os.path.join(root, "JPEGImages", "480p", f"video{v}")
        adir = os.path.join(root, "Annotations", "480p", f"video{v}")
        os.makedirs(fdir)
        os.makedirs(adir)
        for i, (img, ann) in enumerate(zip(frames, annots)):
            cv2.imwrite(os.path.join(fdir, f"{i:05d}.jpg"), img[..., ::-1])
            cv2.imwrite(os.path.join(adir, f"{i:05d}.png"), ann)


def run_parity(dev, totals: dict) -> None:
    """``cli/parity`` on the card, stages 1-4: a made-up full-size
    ``dino-s16`` TimeT.pth in the reference layout (the oracle's seeded
    weights under ``feature_extractor.backbone.<timm key>``, a head [1024,
    1024, 512, 256] as ``nn.Sequential`` indices, 200 unit prototypes), the
    synthetic DAVIS tree of the two clips and a synthetic Pascal tree (64
    val images). Gates: the exit code, stage 1 within the CLI's atols, the
    metrics finite in [0, 1] (agreement, not quality)."""
    import json
    import tempfile

    from timetuning_tpu_torch.cli import parity as cli_parity
    from timetuning_tpu_torch.eval.parity_oracle import build_oracle, build_oracle_head

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        torch.manual_seed(0)
        sd = {f"feature_extractor.backbone.{k}": v for k, v in
              build_oracle(S, 16, 384, 12, 6).state_dict().items()}
        sd.update({f"feature_extractor.head.{k}": v for k, v in
                   build_oracle_head((1024, 1024, 512, 256), 384).state_dict().items()})
        sd["prototypes"] = torch.nn.functional.normalize(torch.randn(200, 256), dim=-1)
        pth = os.path.join(tmp, "TimeT.pth")
        torch.save(sd, pth)
        write_davis_tree(os.path.join(tmp, "davis"))
        write_pascal_tree(os.path.join(tmp, "voc"), n_train=0, n_val=64)
        print(f"parity: checkpoint and trees written in {time.perf_counter() - t0:.1f} s",
              flush=True)
        report = os.path.join(tmp, "report.json")
        t0 = time.perf_counter()
        rc, counts = counted(("parity", "float32"), lambda: cli_parity.main([
            "--timet_pth", pth, "--architecture", "dino-s16",
            "--davis_root", os.path.join(tmp, "davis"),
            "--pascal_root", os.path.join(tmp, "voc"), "--proto_clustering", "true",
            "--num_workers", "2", "--report_json", report, "--device", dev.type]),
            totals)
        wall = time.perf_counter() - t0
        with open(report) as f:
            rows = json.load(f)["rows"]
    for r in rows:
        print(f"parity row: {r}", flush=True)
    print(f"parity: exit code {rc}, {wall:.1f} s for stages 1-4 | launches "
          f"{ {k: n for k, n in counts.items() if n} }", flush=True)
    gated = [r for r in rows if r["expected"] is not None]
    metrics = [r for r in rows if r["expected"] is None]
    if rc != 0 or len(gated) != 3 or not all(r["pass"] for r in gated):
        raise AssertionError("parity: stage 1 failed its gates")
    if len(metrics) != 5 or not all(np.isfinite(r["value"]) and 0 <= r["value"] <= 1
                                    for r in metrics):
        raise AssertionError("parity: a stage 2-4 metric is not finite in [0, 1]")


DP_WORLD = 2                        # ranks of the dp phase, on the one card
DP_STEPS = 6                        # default dp steps (the first one warms up)
DP_F32_B = 4                        # clips a rank of the f32 agreement check
DP_TIMEOUT = 600                    # s the dp phase's ranks may take together


def dp_probe_collectives(dev, group) -> dict:
    """Which collectives the group's backend takes on CUDA tensors (the
    port uses all_reduce and broadcast only)."""
    import torch.distributed as dist

    x = torch.arange(4, dtype=torch.float32, device=dev)
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=group),
        "broadcast": lambda: dist.broadcast(x.clone(), 0, group=group),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            x.new_empty(4 * DP_WORLD), x, group=group),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            x.new_empty(4 // DP_WORLD), x, group=group),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:          # a backend's refusal is the finding
            out[name] = f"{type(e).__name__}: {str(e)[:80]}"
    return out


def dp_replica_mismatches(state, group) -> int:
    """Tensors of the replicated state that differ from rank 0's, bit for
    bit, summed over the ranks (rank 0's broadcast to every rank)."""
    import torch.distributed as dist

    from timetuning_tpu_torch.core.timet import replicated_tensors
    from timetuning_tpu_torch.parallel.mesh import all_reduce_sum

    bad = 0
    for t in replicated_tensors(state).values():
        ref = t.detach().clone()
        dist.broadcast(ref, 0, group=group)
        bad += int(not torch.equal(ref, t))
    dev = state.model.prototypes.device
    return int(all_reduce_sum(torch.tensor([float(bad)], device=dev), group).item())


@contextlib.contextmanager
def dp_collective_times():
    """While open, every ``torch.distributed.all_reduce`` is timed on the
    host between two synchronisations; yields the list of (elements, ms)."""
    import torch.distributed as dist

    rec, real = [], dist.all_reduce

    def timed(t, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(t, *a, **kw)
        torch.cuda.synchronize()
        rec.append((t.numel(), (time.perf_counter() - t0) * 1e3))
        return out

    dist.all_reduce = timed
    try:
        yield rec
    finally:
        dist.all_reduce = real


def dp_steps(dev, group, zero1: bool, n_steps: int, seed: int) -> dict:
    """``n_steps`` flagship bf16 steps at TRAIN_B clips a rank on the data
    axis (host clock between synchronisations: a rank's step includes its
    collectives), the launches of the run, the plain Sinkhorn's calls, peak
    memory, one more step with its all-reduces timed, the replica check."""
    from timetuning_tpu_torch.core import timet
    from timetuning_tpu_torch.ops import kernel_lib
    from timetuning_tpu_torch.ops import sinkhorn as skm
    from timetuning_tpu_torch.parallel.mesh import data_rank

    rank = data_rank(group)
    clip = synthetic_train_clips(TRAIN_B, dev, seed=seed + rank)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, cfg, mask, state, step = build_train(
        dev, torch.bfloat16, zero1=zero1, axis_name="data", world_size=DP_WORLD)
    seen, plain_calls = {}, [0]
    assign, plain = timet.sinkhorn_assignment, skm.sinkhorn

    def recording(scores, *a, **kw):
        seen["scores"] = scores
        return assign(scores, *a, **kw)

    def counting_plain(*a, **kw):
        plain_calls[0] += 1
        return plain(*a, **kw)

    timet.sinkhorn_assignment, skm.sinkhorn = recording, counting_plain
    losses, ms = [], []
    try:
        torch.cuda.synchronize()
        kernel_lib.reset_launch_counts()
        for _ in range(n_steps):
            t0 = time.perf_counter()
            _, metrics = step(state, clip)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = kernel_lib.launch_counts()
    finally:
        timet.sinkhorn_assignment, skm.sinkhorn = assign, plain
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with dp_collective_times() as coll:
        t0 = time.perf_counter()
        step(state, clip)
        torch.cuda.synchronize()
        timed_ms = (time.perf_counter() - t0) * 1e3
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"dp {'zero1' if zero1 else 'default'}: losses {losses} "
                             "are not finite or did not fall on a repeated batch")
    return {"losses": losses, "ms": ms, "counts": counts, "plain_calls": plain_calls[0],
            "peak_gib": peak, "collectives": coll, "timed_step_ms": timed_ms,
            "mismatches": dp_replica_mismatches(state, group),
            "partition": timet.state_partition_specs(state),
            "opt_elements": (state.opt.mu.numel() if zero1 else sum(
                v.numel() for st in state.opt.adamw.state.values()
                for v in st.values() if torch.is_tensor(v) and v.dim()) // 2),
            "scores": seen["scores"].detach().clone()}


def dp_sinkhorn(dev, group, scores) -> dict:
    """Kernel 11's cross-rank form on a dp step's own scores [6,272, 200] a
    rank against the plain group form (the matvec form with the
    all-reduces), both timed over 20 calls in step on both ranks (host
    clock between synchronisations: the all-reduces are host round trips);
    the 2-rank result against the one-launch kernel 11 on the concatenated
    [12,544, 200] (on rank 0)."""
    from timetuning_tpu_torch.ops import sinkhorn as skm
    from timetuning_tpu_torch.ops import sinkhorn_cuda as sk
    from timetuning_tpu_torch.parallel.mesh import all_gather_rows, data_rank

    eps, iters = 0.05, 10
    kern = sk.sinkhorn_assignment_dp_cuda(scores, eps, iters, group=group,
                                          world_size=DP_WORLD)
    plain = skm.sinkhorn(torch.exp(scores / eps).t(), iters, group=group,
                         world_size=DP_WORLD)
    err = float((kern - plain).abs().max())

    def timed(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    ms = timed(lambda: sk.sinkhorn_assignment_dp_cuda(scores, eps, iters, group=group,
                                                     world_size=DP_WORLD))
    plain_ms = timed(lambda: skm.sinkhorn(torch.exp(scores / eps).t(), iters,
                                          group=group, world_size=DP_WORLD))
    s_all, k_all = all_gather_rows(scores, group), all_gather_rows(kern, group)
    err_global = None
    if data_rank(group) == 0:
        one = sk.sinkhorn_assignment_cuda(s_all, eps, iters)
        err_global = float((one - k_all).abs().max())
    B, K = scores.shape
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "err_global": err_global,
            "shape": (B, K), "bound": bound(io_bytes(scores, kern),
                                            (1 + 4 * iters) * B * K, "f32")}


def dp_f32(dev, group) -> dict:
    """2 f32 steps at DP_F32_B clips a rank; rank 0 keeps the losses and the
    trainable parameters."""
    from timetuning_tpu_torch.parallel.mesh import data_rank

    model, _, mask, state, step = build_train(dev, torch.float32, axis_name="data",
                                              world_size=DP_WORLD)
    clip = synthetic_train_clips(DP_F32_B, dev, seed=200 + data_rank(group))
    losses = [float(step(state, clip)[1]["loss"]) for _ in range(2)]
    return {"losses": losses, "params": {n: p.detach().cpu().clone()
                                         for n, p in model.named_parameters() if mask[n]}}


def dp_driver(dev, group, log_dir: str) -> dict:
    """``run_training`` on the data axis: 2 epochs of 4 steps at TRAIN_B clips
    a rank, then a resume for a third epoch; the launches of both runs, the
    step entries' host clock."""
    from timetuning_tpu_torch.core.train import run_training
    from timetuning_tpu_torch.ops import kernel_lib
    from timetuning_tpu_torch.parallel.mesh import data_rank

    root = str(4 * TRAIN_B * DP_WORLD)
    kernel_lib.reset_launch_counts()
    with step_times() as rec:
        first = run_training(driver_config(dev, log_dir, TRAIN_B, data_root=root))
    with step_times() as rec2:
        resumed = run_training(driver_config(dev, log_dir, TRAIN_B, data_root=root,
                                             num_epochs=3, load_checkpoint=True))
    torch.cuda.synchronize()
    return {"counts": kernel_lib.launch_counts(), "steps": rec.steps,
            "resumed_steps": rec2.steps, "first": first["global_step"],
            "resumed": resumed["global_step"], "run_dirs": (first["run_dir"],
                                                            resumed["run_dir"]),
            "mismatches": dp_replica_mismatches(resumed["state"], group),
            "losses": driver_losses(resumed["run_dir"]) if data_rank(group) == 0 else {}}


def _dp_group():
    from timetuning_tpu_torch.parallel.mesh import DATA_AXIS, data_group

    return data_group(DATA_AXIS)


def dp_rank(rank: int, port: int, out_dir: str, log_dir: str) -> None:
    """One rank of the dp phase (a process of ``torch.multiprocessing``):
    gloo on the one card, then the phase's parts in step with the other
    rank; its results to ``out_dir/rank{rank}.pt``."""
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=DP_WORLD, timeout=datetime.timedelta(seconds=120))
    group = _dp_group()
    out = {"collectives": dp_probe_collectives(dev, group)}
    out["default"] = dp_steps(dev, group, False, DP_STEPS, seed=100)
    out["sinkhorn"] = dp_sinkhorn(dev, group, out["default"].pop("scores"))
    out["zero1"] = dp_steps(dev, group, True, 3, seed=100)
    out["zero1"].pop("scores")
    out["f32"] = dp_f32(dev, group)
    if rank != 0:
        out["f32"].pop("params")
    out["driver"] = dp_driver(dev, group, log_dir)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def run_dp(dev, results: dict, totals: dict) -> None:
    """Phase 19: data parallelism on the card, 2 ranks over gloo in two
    processes that share it (NCCL refuses two ranks on one device); they
    show agreement and the cost of the collectives, not the speed of two
    cards. The kernels were built before; the ranks load the library."""
    import socket
    import tempfile
    import types

    import torch.multiprocessing as mp

    from timetuning_tpu_torch.ops import sinkhorn_cuda as sk

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as out_dir, \
            tempfile.TemporaryDirectory() as log_dir:
        t0 = time.perf_counter()
        ctx = mp.start_processes(dp_rank, args=(port, out_dir, log_dir),
                                 nprocs=DP_WORLD, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > DP_TIMEOUT:
                    raise AssertionError(f"dp: the ranks did not finish in {DP_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(DP_WORLD)]
    r0 = ranks[0]
    print(f"dp: {DP_WORLD} ranks over gloo on one card (two processes share it: "
          f"agreement and the cost of the collectives, not the speed of two cards), "
          f"{wall:.1f} s in all; gloo on CUDA tensors: {r0['collectives']}", flush=True)

    per_step = sk.dp_launches(10)
    for name in ("default", "zero1"):
        runs = [r[name] for r in ranks]
        for r, run in enumerate(runs):
            c = run["counts"]
            missing = [k for k in ("attention_block", "mlp_block", "propagation",
                                   "sinkhorn_dp") if c[k] <= 0]
            n = len(run["losses"])
            if missing or c["sinkhorn"] or run["plain_calls"] or c["sinkhorn_dp"] != per_step * n:
                raise AssertionError(
                    f"dp {name} rank {r}: launches {c}, plain Sinkhorn calls "
                    f"{run['plain_calls']} (want the cross-rank K11, {per_step} launches a "
                    f"step, no one-process K11, no matvec form; missing {missing})")
            for k, v in c.items():
                totals[k] = totals.get(k, 0) + v
        if runs[0]["losses"] != runs[1]["losses"]:
            raise AssertionError(f"dp {name}: the ranks' mean losses differ")
        if runs[0]["mismatches"]:
            raise AssertionError(f"dp {name}: {runs[0]['mismatches']} replicated tensors "
                                 "differ between the ranks")
        steady = [float(np.mean(run["ms"][1:])) for run in runs]
        coll = runs[0]["collectives"]
        parts = {}
        for numel, ms in coll:
            parts.setdefault(numel, []).append(ms)
        print(f"dp {name} B={TRAIN_B} a rank bf16: losses "
              f"{[round(v, 5) for v in runs[0]['losses']]} (both ranks equal), step "
              f"{steady[0]:.3f} / {steady[1]:.3f} ms a rank (host clock, steps 2-"
              f"{len(runs[0]['ms'])}) = {DP_WORLD * TRAIN_B / max(steady) * 1e3:.1f} "
              f"clips/s over both ranks; peak memory "
              f"{[round(run['peak_gib'], 3) for run in runs]} GiB a rank; optimizer "
              f"state {[run['opt_elements'] for run in runs]} elements a rank "
              f"({runs[0]['partition']['opt']}); replicated state bit-identical; "
              f"launches {runs[0]['counts']} ({per_step} cross-rank K11 launches a "
              f"step, 0 one-process K11, 0 matvec Sinkhorn calls)", flush=True)
        print(f"dp {name} all-reduce a step (rank 0, each between two "
              f"synchronisations): {sum(ms for _, ms in coll):.3f} ms of a "
              f"{runs[0]['timed_step_ms']:.3f} ms step; by size: " + ", ".join(
                  f"[{n}] x {len(v)}: {sum(v):.3f} ms" for n, v in sorted(parts.items())),
              flush=True)

    sk_r = [r["sinkhorn"] for r in ranks]
    err = max(x["err"] for x in sk_r)
    B, K = sk_r[0]["shape"]
    print(f"dp sinkhorn: cross-rank K11 on the step's scores [{B}, {K}] a rank vs the "
          f"plain group form: max |err| {err:.3e} (gate 1e-6); the 2 ranks vs the "
          f"one-launch K11 on the concatenated [{DP_WORLD * B}, {K}]: max |err| "
          f"{sk_r[0]['err_global']:.3e} (gate 1e-6); kernel {sk_r[0]['ms']:.4f} ms a call "
          f"({per_step} launches, {per_step - 1} all-reduces of [{K + 1}]), plain "
          f"{sk_r[0]['plain_ms']:.4f} ms (host clock, both ranks in step); bound "
          f"{sk_r[0]['bound']['bound_ms']:.5f} ms ({sk_r[0]['bound']['bound_by']}; the "
          f"matrix reread from L2 once an iteration: "
          f"{10 * B * K * 4 / MEM_BYTES_PER_S * 1e3:.5f} ms at 3.35 TB/s)", flush=True)
    if not (err <= 1e-6 and sk_r[0]["err_global"] <= 1e-6):
        raise AssertionError("dp sinkhorn: the cross-rank K11 disagrees")
    # the chain's device time alone: one process, no group, no all-reduce
    s = torch.from_numpy(np.random.default_rng(6272).uniform(-1, 1, (B, K))
                         .astype(np.float32)).to(dev)
    chain = cuda_ms(lambda: sk.sinkhorn_assignment_dp_cuda(s, 0.05, 10))
    one = cuda_ms(lambda: sk.sinkhorn_assignment_cuda(s, 0.05, 10))
    print(f"dp sinkhorn launches alone at [{B}, {K}] (one process, no all-reduce; CUDA "
          f"events behind a device-side sleep): the cross-rank chain {chain:.4f} ms "
          f"({per_step} launches), the one-launch K11 {one:.4f} ms", flush=True)
    results["sinkhorn_dp"] = {"max_abs_err": err, "ms": sk_r[0]["ms"],
                              "plain_ms": sk_r[0]["plain_ms"], "library_ms": None,
                              **sk_r[0]["bound"]}

    # the 2-rank f32 steps against one process on the concatenated batch
    model, _, mask, state, step = build_train(dev, torch.float32)
    clip = torch.cat([synthetic_train_clips(DP_F32_B, dev, seed=200 + r)
                      for r in range(DP_WORLD)])
    losses = [float(step(state, clip)[1]["loss"]) for _ in range(2)]
    got = ranks[0]["f32"]
    rel = abs(got["losses"][0] - losses[0]) / abs(losses[0])
    diffs = torch.cat([(got["params"][n] - p.detach().cpu()).abs().reshape(-1)
                       for n, p in model.named_parameters() if mask[n]])
    close = float(torch.cat([torch.isclose(got["params"][n], p.detach().cpu(),
                                           rtol=1e-3, atol=1e-6).reshape(-1)
                             for n, p in model.named_parameters() if mask[n]])
                  .float().mean())
    print(f"dp f32 {DP_WORLD} x {DP_F32_B} clips vs one process on the {DP_WORLD * DP_F32_B}: "
          f"first loss {got['losses'][0]:.7f} vs {losses[0]:.7f} (relative {rel:.3e}, "
          f"gate 1e-4); trainable parameters after 2 steps: max |diff| "
          f"{float(diffs.max()):.3e} (gate 4e-4: two Adam steps of lr 1e-4), "
          f"{close:.5f} of the entries equal to rtol 1e-3 (gate 0.99)", flush=True)
    if not (rel <= 1e-4 and float(diffs.max()) <= 4e-4 and close >= 0.99):
        raise AssertionError("dp f32: the 2-rank step disagrees with one process")

    drv = [r["driver"] for r in ranks]
    d0 = drv[0]
    if not (d0["first"] == 8 and d0["resumed"] == 12 and drv[1]["resumed"] == 12
            and d0["run_dirs"][0] == d0["run_dirs"][1] == drv[1]["run_dirs"][0]
            and not d0["mismatches"]):
        raise AssertionError(f"dp driver: steps {d0['first']} -> {d0['resumed']}, run "
                             f"dirs {d0['run_dirs']}, {d0['mismatches']} replicas differ")
    missing = [k for k in ("attention_block", "mlp_block", "propagation", "sinkhorn_dp")
               if d0["counts"][k] <= 0]
    if missing or d0["counts"]["sinkhorn"]:
        raise AssertionError(f"dp driver: launches {d0['counts']}")
    for d in drv:
        for k, v in d["counts"].items():
            totals[k] = totals.get(k, 0) + v
    rates = driver_rates(types.SimpleNamespace(steps=d0["steps"]), DP_WORLD * TRAIN_B, 4)
    losses = [d0["losses"][k] for k in sorted(d0["losses"])]
    print(f"dp driver: run_training at {DP_WORLD} ranks x {TRAIN_B} clips, 2 epochs of 4 "
          f"steps then resumed at step 8 to 12 in the same run dir; losses "
          f"{[round(v, 5) for v in losses]}; {rates['window']:.1f} clips/s over both "
          f"ranks across the window of {rates['steps']} steady steps (host clock, rank 0, "
          f"epoch-top saves included), median {rates['median']:.1f} ms a step; launches "
          f"{d0['counts']}", flush=True)
    if not (np.isfinite(losses).all() and len(losses) == 12):
        raise AssertionError(f"dp driver: losses {losses}")


MOE_EVERY_K, MOE_EXPERTS, MOE_CAPACITY = 2, 8, 1.25   # every 2nd block, 8 experts
MOE_FRAMES = 64                     # frames of the moe phase's feature forward
MESH_WORLD = 2                      # ranks of the mesh phases, on the one card
MESH_FRAMES = 16                    # frames of their feature forward
MESH_F32_B = 4                      # clips a step of their f32 agreement run
MESH_TIMEOUT = 600                  # s the ranks of a phase may take together


def moe_vit(dtype, seed: int = 0):
    """(dense, MoE) DINO ViT-S/16 at 224 from ``seed``: the MoE ViT (every 2nd
    block 8 experts, capacity 1.25) sparse-upcycled from the dense weights,
    its routers a seeded init (``cli/export``'s construction), on the host."""
    from timetuning_tpu_torch.models.vit import VisionTransformer, vit_small
    from timetuning_tpu_torch.parallel.ep import upcycle_dense_to_moe

    cfg = vit_small(16, img_size=S, dtype=dtype)
    dense = VisionTransformer(cfg).init_weights(torch.Generator().manual_seed(seed))
    mcfg = dataclasses.replace(cfg, moe_every_k=MOE_EVERY_K, n_experts=MOE_EXPERTS,
                               moe_capacity_factor=MOE_CAPACITY)
    moe = VisionTransformer(mcfg).init_weights(torch.Generator().manual_seed(seed + 1))
    moe.load_state_dict(upcycle_dense_to_moe(dense.state_dict(), moe.state_dict(), mcfg))
    return dense, moe


def mesh_frames(dev, n: int, seed: int = 7) -> torch.Tensor:
    """[n, 224, 224, 3] normalised frames: the train clips' frames."""
    return synthetic_train_clips(-(-n // TRAIN_F), dev, seed=seed).flatten(0, 1)[:n]


def token_cosine(got, want) -> float:
    return float(torch.nn.functional.cosine_similarity(
        got.float(), want.float(), dim=-1).min())


@contextlib.contextmanager
def moe_routes(model):
    """While open, each ``MoEMlp`` call of ``model`` records its tokens'
    route: the top-1 expert, or -1 for a token past the capacity; yields the
    list of [B, S] routes, one a call."""
    from timetuning_tpu_torch.parallel.ep import MoEMlp, switch_capacity

    routes = []

    def hook(mod, args, _out):
        y = args[0]
        B, Sq = y.shape[:2]
        G, Sg = mod.groups(B, Sq)
        logits = torch.nn.functional.linear(y.reshape(G, Sg, -1),
                                            mod.router.weight.to(y.dtype))
        expert = torch.softmax(logits.float(), dim=-1).argmax(dim=-1)
        onehot = torch.nn.functional.one_hot(expert, mod.n_experts).float()
        slot = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1
        kept = slot < switch_capacity(Sg, mod.capacity_factor, mod.n_experts)
        routes.append(torch.where(kept, expert, -1).reshape(B, Sq))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, MoEMlp)]
    try:
        yield routes
    finally:
        for h in handles:
            h.remove()


def moe_gate_check(dev, dense, moe) -> dict:
    """On the card, in f32: the upcycled MoE branch of block 1 equals its
    top-1 gate times the dense block's MLP on the tokens its expert keeps,
    and 0 on the tokens past the capacity (8 x 197 tokens, a routing group
    a sample)."""
    from timetuning_tpu_torch.ops.fused_block import _ln
    from timetuning_tpu_torch.parallel.ep import switch_capacity

    bm, bd = moe.blocks[1], dense.blocks[1]
    x = torch.randn(8, 197, 384, generator=torch.Generator().manual_seed(11)).to(dev)
    with torch.no_grad():
        y = _ln(x, bm.norm2.weight, bm.norm2.bias)
        got = bm.moe(y)
        dense_out = bd.mlp(y)
        probs = torch.softmax(y @ bm.moe.router.weight.t(), dim=-1)
        gate, expert = probs.max(dim=-1)
        onehot = torch.nn.functional.one_hot(expert, MOE_EXPERTS).float()
        slot = ((torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1)
        kept = slot < switch_capacity(197, MOE_CAPACITY, MOE_EXPERTS)
        want = torch.where(kept[..., None], gate[..., None] * dense_out,
                           torch.zeros_like(dense_out))
    err = float((got - want).abs().max())
    return {"err": err, "kept": int(kept.sum()), "tokens": kept.numel(),
            "dropped_zero": bool((got[~kept] == 0).all())}


def run_moe(dev, totals: dict) -> None:
    """The ``moe`` phase: the MoE ViT-S/16 (every 2nd block 8 experts,
    upcycled) in one process on the card: the gate check; bf16 through
    kernels 1 and 2 against the f32 plain forward on 64 frames; the bf16
    feature forward's time and launches (K1 in all 12 blocks, K2 in the 6
    dense ones); 3 flagship TimeT steps at 32 clips with the Switch
    auxiliary (``moe_aux_weight=0.01``; block 11, on the grad path, is MoE);
    the ``--moe_every_k 2 --moe_experts 8`` export and its round trip."""
    import tempfile

    from timetuning_tpu_torch.cli import export as texport

    dense, moe = moe_vit(torch.bfloat16)
    dense, moe = dense.to(dev).eval(), moe.to(dev).eval()
    gate = moe_gate_check(dev, dense, moe)
    print(f"moe gate (block 1, f32 on the card, 8 x 197 tokens): the MoE branch vs "
          f"gate x dense MLP: max |err| {gate['err']:.3e} (gate 1e-4); {gate['kept']} of "
          f"{gate['tokens']} tokens kept, the dropped ones exactly 0: "
          f"{gate['dropped_zero']}", flush=True)
    if not (gate["err"] <= 1e-4 and gate["dropped_zero"]):
        raise AssertionError("moe gate: the upcycled MoE branch is not gate x dense MLP")

    frames = mesh_frames(dev, MOE_FRAMES)
    f32 = dataclasses.replace(moe.config, dtype=torch.float32)
    from timetuning_tpu_torch.models.vit import VisionTransformer

    moe32 = VisionTransformer(f32).to(dev).eval()
    moe32.load_state_dict(moe.state_dict())
    with torch.no_grad():
        with moe_routes(moe) as r16:
            (got,), counts = counted(("moe", "forward"), lambda: (moe(frames)["tokens"],),
                                     totals)
        with moe_routes(moe32) as r32:
            want = moe32(frames)["tokens"]
        ms = cuda_ms(lambda: moe(frames), warmup=1, reps=5, queued=False)
        ms32 = cuda_ms(lambda: moe32(frames), warmup=1, reps=3, queued=False)
    # top-1 routing is discrete: a near-tie of two experts, or a slot taken
    # by another token's flip, routes a token otherwise in bf16 than in f32
    same = torch.stack([a == b for a, b in zip(r16, r32)]).all(dim=0)
    cos_all = torch.nn.functional.cosine_similarity(got.float(), want.float(), dim=-1)
    cos = float(cos_all[same].min())
    print(f"moe forward {MOE_FRAMES} frames ViT-S/16 MoE (8 experts, every 2nd block) bf16: "
          f"{ms:.3f} ms ({MOE_FRAMES / ms * 1e3:.1f} frames/s; f32 plain {ms32:.3f} ms); "
          f"tokens routed alike in bf16 and f32 in all 6 MoE blocks "
          f"{int(same.sum())} of {same.numel()}: min per-token cosine {cos:.6f} (gate "
          f"0.999); the others min {float(cos_all[~same].min()) if (~same).any() else 1:.6f}, "
          f"all tokens mean {float(cos_all.mean()):.6f} (gate 0.999) | launches {counts}",
          flush=True)
    if cos < 0.999 or float(cos_all.mean()) < 0.999 or not torch.isfinite(got).all():
        raise AssertionError("moe forward: bf16 disagrees with f32")
    if counts["attention_block"] != 12 or counts["mlp_block"] != 6:
        raise AssertionError(f"moe forward: launches {counts}, expected K1 12 and K2 6")
    del moe32, want

    clip = synthetic_train_clips(TRAIN_B, dev)
    model, cfg, mask, state, step = build_train(dev, torch.bfloat16, moe=True,
                                                moe_aux_weight=0.01)
    before = _params(model)
    teacher_before = {n: t.clone() for n, t in state.teacher.items()}
    losses, auxes, times = [], [], []

    def steps():
        for i in range(3):
            if i == 2:
                teacher_before.update({n: t.clone() for n, t in state.teacher.items()})
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            _, m = step(state, clip)
            ev[1].record()
            losses.append(m["loss"])
            auxes.append(m["moe_aux"])
            times.append(ev)

    torch.cuda.reset_peak_memory_stats()
    _, counts = counted(("moe", "step"), steps, totals)
    losses, auxes = [float(v) for v in losses], [float(v) for v in auxes]
    ms = [a.elapsed_time(b) for a, b in times]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"moe train B={TRAIN_B} bf16 (moe_aux_weight 0.01, 10 frozen trunk blocks, block "
          f"11 MoE): losses {[round(v, 5) for v in losses]}, moe_aux "
          f"{[round(v, 5) for v in auxes]}; step {[round(v, 3) for v in ms]} ms (CUDA "
          f"events; beside the dense default step of this run), peak memory "
          f"{peak:.3f} GiB | "
          f"launches {counts}", flush=True)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]
            and all(1.0 <= a <= MOE_EXPERTS for a in auxes)):
        raise AssertionError(f"moe train: losses {losses}, moe_aux {auxes}")
    check_train_state("moe train", model, mask, state, before, teacher_before)
    want = {"attention_block": 14 * 3, "mlp_block": 7 * 3, "propagation": 3, "sinkhorn": 3}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"moe train: launches {counts}, expected {want}")
    del model, state, step, clip

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        blob, live, shape, _ = texport.export_features(
            "dino-s16", None, 8, S, "bfloat16", moe_every_k=MOE_EVERY_K,
            moe_experts=MOE_EXPERTS, device=str(dev))
        export_s = time.perf_counter() - t0
        path = os.path.join(tmp, "moe.pt2")
        with open(path, "wb") as f:
            f.write(blob)
        fn = texport.load_exported(path)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, shape, np.uint8)).to(dev)
    with torch.no_grad():
        (got,), counts = counted(("moe", "export"), lambda: (fn(x),), totals)
        want = live(x)
    err = float((got.float() - want.float()).abs().max())
    print(f"moe export dino-s16 --moe_every_k {MOE_EVERY_K} --moe_experts {MOE_EXPERTS} "
          f"batch 8 bf16: {export_s:.1f} s, {len(blob) / 1e6:.1f} MB; "
          f"round trip max |err| {err:.3e} (gate 1e-3) | launches of one call {counts}",
          flush=True)
    if err > 1e-3 or counts["preprocess"] != 1 or counts["attention_block"] != 12 \
            or counts["mlp_block"] != 6:
        raise AssertionError("moe export: round trip or launches")


def mesh_rank(rank: int, kind: str, port: int, out_dir: str, log_dir: str) -> None:
    """One rank of the ``ep``, ``tp``, ``sp pp`` or ``export mesh`` phase (a
    ``torch.multiprocessing`` process): gloo on the one card, the phase's
    parts in step with the other rank (``MESH_WORK[kind]``), its results to
    ``out_dir/rank{rank}.pt``."""
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=MESH_WORLD, timeout=datetime.timedelta(seconds=120))
    out = MESH_WORK[kind](dev, rank, port, log_dir)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def mesh_steps(dev, label: str, n_steps: int, **kw) -> dict:
    """``n_steps`` bf16 flagship steps at TRAIN_B clips on a 2-D mesh (host
    clock between synchronisations), their launches, one more step with its
    all-reduces timed, the replica check; then 2 f32 steps at MESH_F32_B."""
    from timetuning_tpu_torch.core.timet import sharded_tensors
    from timetuning_tpu_torch.ops import kernel_lib

    clip = synthetic_train_clips(TRAIN_B, dev, seed=300)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, cfg, mask, state, step = build_train(dev, torch.bfloat16, **kw)
    losses, auxes, ms = [], [], []
    torch.cuda.synchronize()
    kernel_lib.reset_launch_counts()
    for _ in range(n_steps):
        t0 = time.perf_counter()
        _, m = step(state, clip)
        losses.append(float(m["loss"]))
        auxes.append(float(m["moe_aux"]) if "moe_aux" in m else None)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = kernel_lib.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with dp_collective_times() as coll:
        t0 = time.perf_counter()
        step(state, clip)
        torch.cuda.synchronize()
        timed_ms = (time.perf_counter() - t0) * 1e3
    shapes = {n: tuple(v.shape) for n, v in sharded_tensors(state).items()
              if n.startswith("params.")}
    out = {"losses": losses, "aux": auxes, "ms": ms, "counts": counts, "peak_gib": peak,
           "collectives": coll, "timed_step_ms": timed_ms, "shapes": shapes,
           "mismatches": dp_replica_mismatches(state, None)}
    del model, state, step
    _, _, _, state, step = build_train(dev, torch.float32, **kw)
    clip = synthetic_train_clips(MESH_F32_B, dev, seed=301)
    out["f32"] = [float(step(state, clip)[1]["loss"]) for _ in range(2)]
    return out


def ep_work(dev, rank: int, port: int, log_dir: str) -> dict:
    from timetuning_tpu_torch.parallel import ep

    mesh = ep.make_dp_ep_mesh(1, MESH_WORLD)
    _, moe = moe_vit(torch.bfloat16)
    moe = moe.to(dev).eval()
    ep.shard_experts(mesh, moe)
    frames = mesh_frames(dev, MESH_FRAMES)
    with torch.no_grad():
        tokens = moe(frames)["tokens"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moe(frames)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
    out = mesh_steps(dev, "ep", 3, moe=True, moe_aux_weight=0.01,
                     shard=lambda m: ep.shard_experts(mesh, m), mesh=mesh)
    out.update(tokens=tokens.float().cpu(), fwd_ms=fwd_ms,
               experts=int(moe.blocks[1].moe.w1.shape[0]))
    return out


def tp_work(dev, rank: int, port: int, log_dir: str) -> dict:
    """The tp rank: the feature forward, the steps, a checkpoint of the TP
    state beside its gathered parameters, then ``cli/train --multihost true
    --tensor_parallel 2`` for an epoch of 2 steps and a resumed second (each
    run takes down its group, so the runs come last)."""
    import contextlib as _cl
    import io

    import torch.distributed as dist

    from timetuning_tpu_torch.cli import train as tcli
    from timetuning_tpu_torch.core.checkpoint import save_checkpoint
    from timetuning_tpu_torch.models.vit import VisionTransformer, vit_small
    from timetuning_tpu_torch.parallel import tp
    from timetuning_tpu_torch.parallel.mesh import data_group

    mesh = tp.make_dp_tp_mesh(1, MESH_WORLD)
    vit = VisionTransformer(vit_small(16, img_size=S, dtype=torch.bfloat16)).init_weights(
        torch.Generator().manual_seed(0)).to(dev).eval()
    tp.shard_params(mesh, vit)
    frames = mesh_frames(dev, MESH_FRAMES)
    with torch.no_grad():
        tokens = vit(frames)["tokens"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vit(frames)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3

    def shard(m):
        tp.force_xla_attention(m)
        tp.shard_params(mesh, m)

    out = mesh_steps(dev, "tp", 3, shard=shard, mesh=mesh)
    out.update(tokens=tokens.float().cpu(), fwd_ms=fwd_ms)
    # a checkpoint of a TP state (2 f32 steps) and its gathered parameters
    model, _, _, state, step = build_train(dev, torch.float32, shard=shard, mesh=mesh)
    step(state, synthetic_train_clips(MESH_F32_B, dev, seed=302))
    ckpt = os.path.join(log_dir, "tp_state")
    os.makedirs(ckpt, exist_ok=True)
    save_checkpoint(state, ckpt, 1, group=data_group("data"))
    out["gathered"] = tp.gather_global_params(model)
    out["ckpt"] = ckpt
    del model, state, step
    torch.cuda.empty_cache()

    name = register_synthetic_dataset()
    argv = ["--multihost", "true", "--tensor_parallel", str(MESH_WORLD), "--device", "cuda:0",
            "--architecture", "dino-s16", "--dataset", name,
            "--data_root", str(2 * TRAIN_B), "--batch_size", str(TRAIN_B // MESH_WORLD),
            "--num_frames", "4", "--num_workers", "2", "--log_dir",
            os.path.join(log_dir, "cli"), "--use_queue", "true", "--queue_size", "4096"]
    printed, cli_ms = [], []
    for i, extra in enumerate((["--num_epochs", "1"],
                               ["--num_epochs", "2", "--load_checkpoint", "true"])):
        if dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()
        # gloo (two ranks share the card); cli/train keeps a group it finds
        os.environ.update(RANK=str(rank), LOCAL_RANK="0", WORLD_SIZE=str(MESH_WORLD),
                          MASTER_ADDR="localhost", MASTER_PORT=str(port + 1 + i))
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port + 1 + i}",
                                rank=rank, world_size=MESH_WORLD)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with _cl.redirect_stdout(buf):
            if tcli.main(argv + extra) != 0:
                raise AssertionError(f"tp: cli/train {extra} failed")
        cli_ms.append((time.perf_counter() - t0) * 1e3)
        printed.append(buf.getvalue())
    out.update(cli=printed, cli_ms=cli_ms, cli_dir=os.path.join(log_dir, "cli"))
    return out


def run_mesh_ranks(kind: str, log_dir: str | None = None) -> list[dict]:
    """Start the ``MESH_WORLD`` ranks of the ``kind`` phase and collect them
    (killed at MESH_TIMEOUT); the ranks' log dir (a new one unless given)
    stays for the checks."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{kind}_")
    t0 = time.perf_counter()
    ctx = mp.start_processes(mesh_rank, args=(kind, port, out_dir, log_dir or out_dir),
                             nprocs=MESH_WORLD, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > MESH_TIMEOUT:
                raise AssertionError(f"{kind}: the ranks did not finish in {MESH_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(MESH_WORLD)]
    ranks[0]["wall_s"] = time.perf_counter() - t0
    ranks[0]["dir"] = out_dir
    return ranks


def one_process_reference(dev, **kw) -> dict:
    """The mesh phases' one-process references: the same bf16 steps at
    TRAIN_B clips and 2 f32 steps at MESH_F32_B."""
    clip = synthetic_train_clips(TRAIN_B, dev, seed=300)
    _, _, _, state, step = build_train(dev, torch.bfloat16, **kw)
    bf16 = [float(step(state, clip)[1]["loss"]) for _ in range(3)]
    del state, step
    _, _, _, state, step = build_train(dev, torch.float32, **kw)
    clip = synthetic_train_clips(MESH_F32_B, dev, seed=301)
    return {"bf16": bf16, "f32": [float(step(state, clip)[1]["loss"]) for _ in range(2)]}


def mesh_report(kind: str, ranks: list, ref: dict, want_tokens, path: tuple,
                totals: dict) -> None:
    """The ``ep`` / ``tp`` gates: features (cosine), bf16 and f32 losses
    against one process, the ranks' losses equal, replicated state
    bit-identical, the path's launches; and the all-reduce ms a step."""
    r0 = ranks[0]
    cos = min(token_cosine(r["tokens"], want_tokens) for r in ranks)
    rel = max(abs(a - b) / abs(b) for a, b in zip(r0["f32"], ref["f32"]))
    rel16 = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], ref["bf16"]))
    coll = r0["collectives"]
    steady = [float(np.mean(r["ms"][1:])) for r in ranks]
    print(f"{kind}: {MESH_WORLD} gloo ranks on one card (dp 1 x {kind[0]}p {MESH_WORLD}: "
          f"agreement and the cost of the collectives, not the speed of two cards), "
          f"{r0['wall_s']:.1f} s in all; feature forward {MESH_FRAMES} frames bf16 "
          f"{r0['fwd_ms']:.3f} ms a rank (host clock), min per-token cosine vs one process "
          f"{cos:.6f} (gate 0.999); bf16 B={TRAIN_B} losses "
          f"{[round(v, 5) for v in r0['losses']]} vs one process "
          f"{[round(v, 5) for v in ref['bf16']]} (relative {rel16:.3e}, gate 1e-2)"
          + (f", moe_aux {[round(v, 5) for v in r0['aux']]}" if r0["aux"][0] is not None
             else "") + f"; f32 B={MESH_F32_B} 2 steps: losses {r0['f32']} vs "
          f"{ref['f32']} (relative {rel:.3e}, gate 1e-5); step "
          f"{steady[0]:.3f} / {steady[1]:.3f} ms a rank (host clock, steps 2-3), peak "
          f"{[round(r['peak_gib'], 3) for r in ranks]} GiB a rank; replicated state "
          f"mismatches {r0['mismatches']} | launches {r0['counts']}", flush=True)
    print(f"{kind} all-reduce a step (rank 0, each between two synchronisations) in a "
          f"{r0['timed_step_ms']:.3f} ms step: {collective_line(coll)}", flush=True)
    if not (cos >= 0.999 and rel <= 1e-5 and rel16 <= 1e-2
            and ranks[0]["losses"] == ranks[1]["losses"] and not r0["mismatches"]):
        raise AssertionError(f"{kind}: the mesh disagrees with one process or itself")
    for r in ranks:
        add_counts(path, r["counts"], totals, {})


def run_ep(dev, totals: dict) -> None:
    """The ``ep`` phase: the moe phase's model on a dp 1 x ep 2 mesh of 2
    gloo ranks sharing the card, against one process."""
    ranks = run_mesh_ranks("ep")
    _, moe = moe_vit(torch.bfloat16)
    with torch.no_grad():
        want = moe.to(dev).eval()(mesh_frames(dev, MESH_FRAMES))["tokens"].float().cpu()
    del moe
    ref = one_process_reference(dev, moe=True, moe_aux_weight=0.01)
    mesh_report("ep", ranks, ref, want, ("ep", "step"), totals)
    held = [r["experts"] for r in ranks]
    shapes = ranks[0]["shapes"]
    w1 = shapes["params.feature_extractor.backbone.blocks.11.moe.w1"]
    print(f"ep experts held a rank: {held} of {MOE_EXPERTS} (block 11 w1 {list(w1)}); "
          f"{len(shapes)} sharded leaves a rank", flush=True)
    if held != [MOE_EXPERTS // MESH_WORLD] * MESH_WORLD or w1[0] != MOE_EXPERTS // MESH_WORLD:
        raise AssertionError("ep: a rank does not hold 4 of the 8 experts")
    c = ranks[0]["counts"]
    if c["attention_block"] != 14 * 3 or c["mlp_block"] != 7 * 3 or c["sinkhorn"] != 3:
        raise AssertionError(f"ep: launches {c}")
    shutil.rmtree(ranks[0]["dir"], ignore_errors=True)


def run_tp(dev, totals: dict) -> None:
    """The ``tp`` phase: the flagship dense model on a dp 1 x tp 2 mesh of 2
    gloo ranks sharing the card (plain attention: the block kernels take
    whole weights), against one process on plain attention; the TP
    checkpoint in one process; ``cli/train --tensor_parallel 2`` and its
    resume, then one process resuming its checkpoint."""
    from timetuning_tpu_torch.core.checkpoint import load_checkpoint
    from timetuning_tpu_torch.core.train import run_training
    from timetuning_tpu_torch.models.vit import VisionTransformer, vit_small
    from timetuning_tpu_torch.parallel import tp

    ranks = run_mesh_ranks("tp")
    vit = VisionTransformer(vit_small(16, img_size=S, dtype=torch.bfloat16,
                                      attn_impl="xla")).init_weights(
        torch.Generator().manual_seed(0)).to(dev).eval()
    with torch.no_grad():
        want = vit(mesh_frames(dev, MESH_FRAMES))["tokens"].float().cpu()
    del vit
    ref = one_process_reference(dev, shard=tp.force_xla_attention)
    mesh_report("tp", ranks, ref, want, ("tp", "step"), totals)
    r0 = ranks[0]
    b0 = "params.feature_extractor.backbone.blocks.0."
    shapes = {k[len(b0):]: v for k, v in r0["shapes"].items() if k.startswith(b0)}
    print(f"tp slices a rank (block 0): {shapes}", flush=True)
    if shapes != {"attn.qkv.weight": (576, 384), "attn.qkv.bias": (576,),
                  "attn.proj.weight": (384, 192), "mlp.fc1.weight": (768, 384),
                  "mlp.fc1.bias": (768,), "mlp.fc2.weight": (384, 768)}:
        raise AssertionError("tp: a rank does not hold half of qkv, fc1, proj and fc2")
    c = r0["counts"]
    if c["attention_block"] or c["mlp_block"] or c["propagation"] != 3 or c["sinkhorn"] != 3:
        raise AssertionError(f"tp: launches {c} (want K3 and K11 3 times, no K1 / K2)")

    # the TP checkpoint in one process equals the gathered parameters
    model, _, _, state, _ = build_train(dev, torch.float32)
    load_checkpoint(r0["ckpt"], state)
    diff = [k for k, v in model.state_dict().items()
            if not torch.equal(v.cpu(), r0["gathered"][k])]
    # cli/train --tensor_parallel 2 (epoch 1, then resumed to 2): the ranks
    # print one run dir; one process resumes it for a third epoch
    dirs = [[x.split("run_dir=")[1].split()[0] for x in out.splitlines()
             if x.startswith("done: run_dir=")][0] for out in r0["cli"]]
    meta = json.load(open(os.path.join(dirs[0], "checkpoint_meta.json")))
    one = run_training(driver_config(dev, r0["cli_dir"], TRAIN_B,
                                     data_root=str(2 * TRAIN_B), num_epochs=3,
                                     max_steps_per_epoch=2, load_checkpoint=True,
                                     use_queue=True, queue_size=4096))
    print(f"tp checkpoint: the TP state's checkpoint loaded into one process vs the ranks' "
          f"gathered parameters: {len(diff)} tensors differ (gate 0); cli/train "
          f"--multihost true --tensor_parallel 2: {[round(v / 1e3, 1) for v in r0['cli_ms']]}"
          f" s for epoch 1 and the resumed epoch 2 (2 steps each, one run dir: "
          f"{dirs[0] == dirs[1]}, meta tensor_parallel {meta['tensor_parallel']}), then one "
          f"process resumed it to step {one['global_step']} (loss {one['final_loss']:.5f})",
          flush=True)
    if diff or dirs[0] != dirs[1] or meta["tensor_parallel"] != MESH_WORLD \
            or one["global_step"] != 6 or not np.isfinite(one["final_loss"]):
        raise AssertionError("tp: checkpoint or cli/train run")
    shutil.rmtree(r0["dir"], ignore_errors=True)


SP_BATCH = 4                        # frames of the sp phase: the S/8 serving program's
PP_BATCH = 64                       # frames of the pp phase: JAX's export default
PP_MICRO = (None, 4)                # n_micro of the pp phase: auto (2), then 4
# the multi-device programs of the export mesh phase: (architecture, input
# resolution, batch, cli/export flags), each on 2 ranks
MESH_PROGRAMS = {
    "tp": ("dino-s16", S, PP_BATCH, {"tensor_parallel": MESH_WORLD}),
    "ep": ("dino-s16", S, PP_BATCH, {"expert_parallel": MESH_WORLD,
                                     "moe_every_k": MOE_EVERY_K, "moe_experts": MOE_EXPERTS}),
    "sp": ("dino-s8", S8, SP_BATCH, {"sequence_parallel": MESH_WORLD}),
    "pp": ("dino-s16", S, PP_BATCH, {"pipeline_parallel": MESH_WORLD}),
    "dp": ("dino-s16", S, PP_BATCH, {"data_parallel": MESH_WORLD}),
}


def s8_frames(dev) -> torch.Tensor:
    """[SP_BATCH, 448, 448, 3] normalised frames: the train clips' frames
    resized to 448."""
    x = mesh_frames(dev, SP_BATCH).permute(0, 3, 1, 2)
    return torch.nn.functional.interpolate(x, size=(S8, S8), mode="bilinear").permute(
        0, 2, 3, 1).contiguous()


def export_frames(dev, batch: int, size: int) -> torch.Tensor:
    """The uint8 frames of the export mesh phase (seeded, the same in every
    process)."""
    return torch.from_numpy(np.random.default_rng(21).integers(
        0, 256, (batch, size, size, 3), np.uint8)).to(dev)


def mesh_forward(fwd, x, reps: int = 3) -> dict:
    """A mesh forward on this rank: its tokens and launches (counts set to 0
    just before, read just after), then one forward with each all-reduce
    timed between two synchronisations, then ``reps`` forwards timed on the
    host clock."""
    from timetuning_tpu_torch.ops import kernel_lib

    with torch.no_grad():
        torch.cuda.synchronize()
        kernel_lib.reset_launch_counts()
        tokens = fwd(x)
        torch.cuda.synchronize()
        counts = kernel_lib.launch_counts()
        with dp_collective_times() as coll:
            fwd(x)
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fwd(x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    return {"tokens": tokens.float().cpu(), "counts": counts, "ms": ms, "collectives": coll}


def param_bytes(module) -> int:
    return sum(p.numel() * p.element_size() for p in module.parameters())


def sp_pp_work(dev, rank: int, port: int, log_dir: str) -> dict:
    """The sp and pp rank: dino-s8 at 448 on a dp 1 x sp 2 mesh (SP_BATCH
    frames), then dino-s16 at 224 on a dp 1 x pp 2 mesh (PP_BATCH frames, at
    each n_micro of PP_MICRO), each in bf16 and f32 (``mesh_forward``)."""
    from timetuning_tpu_torch.models.registry import get_backbone
    from timetuning_tpu_torch.parallel import pp, sp

    out = {}
    mesh = sp.make_dp_sp_mesh(1, MESH_WORLD)
    x = s8_frames(dev)
    for dtype in (torch.bfloat16, torch.float32):
        vit = get_backbone("dino-s8", dtype=dtype, device=dev).module.eval()
        out[("sp", str(dtype).split(".")[1])] = mesh_forward(sp.make_sp_feature_fn(vit, mesh), x)
        del vit
    mesh = pp.make_dp_pp_mesh(1, MESH_WORLD)
    x = mesh_frames(dev, PP_BATCH)
    for dtype in (torch.bfloat16, torch.float32):
        vit = get_backbone("dino-s16", dtype=dtype, device=dev).module.eval()
        whole = param_bytes(vit)
        for nm in PP_MICRO:
            res = mesh_forward(pp.make_pp_feature_fn(vit, mesh, nm), x)
            res.update(param_bytes=param_bytes(vit), whole_bytes=whole,
                       stage=list(vit.pipe_stage))
            out[("pp", str(dtype).split(".")[1], nm)] = res
        del vit
    return out


def export_work(dev, rank: int, port: int, log_dir: str) -> dict:
    """The exporting rank: each program of MESH_PROGRAMS exported
    (``cli/export.export_features``, bf16) and written with its manifest to
    ``log_dir`` (``save_exported``); this rank's live mesh forward on its
    data slice of the frames, and its ms (host clock, 3 calls)."""
    from timetuning_tpu_torch.cli import export as texport

    out = {}
    for name, (arch, size, batch, flags) in MESH_PROGRAMS.items():
        t0 = time.perf_counter()
        blob, live, _, em = texport.export_features(arch, None, batch, size, "bfloat16",
                                                    device=str(dev), **flags)
        export_s = time.perf_counter() - t0
        sizes = texport.save_exported(os.path.join(log_dir, f"{name}.json"), blob, em)
        x = em.local_slice(export_frames(dev, batch, size))
        with torch.no_grad():
            want = live(x)
            torch.cuda.synchronize()
            ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                live(x)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"export_s": export_s, "sizes": sizes, "live": want.float().cpu(),
                     "live_ms": ms, "coords": em.coords}
        del blob, live
        torch.cuda.empty_cache()
    return out


def load_work(dev, rank: int, port: int, log_dir: str) -> dict:
    """The loading rank (a fresh process): each program of MESH_PROGRAMS
    loaded from ``log_dir`` (``cli/export.load_exported``) and called on
    this rank's data slice (``mesh_forward``)."""
    from timetuning_tpu_torch.cli import export as texport

    out = {}
    for name, (arch, size, batch, flags) in MESH_PROGRAMS.items():
        path = os.path.join(log_dir, f"{name}.json")
        fn = texport.load_exported(path)
        manifest = json.load(open(path))
        d = manifest["ranks"][rank]["coords"][0]
        b = batch // manifest["axis_sizes"][0]
        out[name] = mesh_forward(fn, export_frames(dev, batch, size)[d * b:(d + 1) * b])
        out[name]["coords"] = tuple(manifest["ranks"][rank]["coords"])
        del fn
    return out


MESH_WORK = {"ep": ep_work, "tp": tp_work, "sp_pp": sp_pp_work, "export": export_work,
             "load": load_work}


def collective_line(coll) -> str:
    """The all-reduces of one forward by size: calls and ms."""
    sizes = {}
    for numel, ms in coll:
        sizes.setdefault(numel, []).append(ms)
    return (f"{sum(ms for _, ms in coll):.3f} ms in {len(coll)} all-reduces; by size: "
            + ", ".join(f"[{n}] x {len(v)}: {sum(v):.3f} ms" for n, v in sorted(sizes.items())))


def mesh_gate(label: str, ranks: list, want, dtype: str) -> str:
    """The ranks' tokens against the one-process forward: bf16 per-token
    cosine >= 0.999, f32 max |diff| <= 1e-4 (TF32 off); returns the line's
    numbers."""
    if dtype == "bfloat16":
        cos = min(token_cosine(r, want) for r in ranks)
        if not cos >= 0.999:
            raise AssertionError(f"{label}: min per-token cosine {cos:.6f} against one process")
        return f"min per-token cosine vs one process {cos:.6f} (gate 0.999)"
    err = max(float((r - want).abs().max()) for r in ranks)
    if not err <= 1e-4:
        raise AssertionError(f"{label}: max |diff| {err:.3e} against one process")
    return f"max |diff| vs one process {err:.3e} (gate 1e-4, TF32 off)"


def add_counts(path: tuple, counts: dict, totals: dict, want: dict) -> None:
    """A rank's launches of a main-path run: the path's kernels all
    launched, ``want``'s exactly; added to ``totals``."""
    missing = [k for k in PATH_KERNELS[path] if counts[k] <= 0]
    wrong = {k: counts[k] for k, n in want.items() if counts[k] != n}
    if missing or wrong:
        raise AssertionError(f"{path}: kernels not launched {missing}, launches {wrong} "
                             f"where {want} were expected")
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v


def run_sp_pp(dev, totals: dict) -> None:
    """The ``sp`` and ``pp`` phases: 2 gloo ranks sharing the card
    (``sp_pp_work``) against the one-process forward of the same seeded
    weights on the same frames."""
    from timetuning_tpu_torch.models.registry import get_backbone

    ranks = run_mesh_ranks("sp_pp")
    print(f"sp pp: {MESH_WORLD} gloo ranks on one card (agreement and the cost of the "
          f"collectives, not the speed of two cards), {ranks[0]['wall_s']:.1f} s in all",
          flush=True)
    T8 = (S8 // 8) ** 2 + 1
    for dtype in ("bfloat16", "float32"):
        vit = get_backbone("dino-s8", dtype=getattr(torch, dtype), device=dev).module.eval()
        with torch.no_grad():
            want = vit(s8_frames(dev))["tokens"].float().cpu()
        del vit
        rs = [r[("sp", dtype)] for r in ranks]
        gate = mesh_gate(f"sp {dtype}", [r["tokens"] for r in rs], want, dtype)
        kernels = (("ln_dense", "flash_attention", "dense_residual", "mlp_rows")
                   if dtype == "bfloat16" else ("flash_attention",))
        for r in rs:
            add_counts(("sp", dtype), r["counts"], totals, {k: 12 for k in kernels})
        print(f"sp dino-s8 {S8} {dtype} batch {SP_BATCH}, dp 1 x sp {MESH_WORLD} "
              f"({T8} tokens, {-(-T8 // MESH_WORLD)} rows a slab): {gate}; forward "
              f"{[round(v, 3) for v in rs[0]['ms']]} / {[round(v, 3) for v in rs[1]['ms']]} "
              f"ms a rank (host clock); the K/V all-gathers and the output's, rank 0: "
              f"{collective_line(rs[0]['collectives'])} | launches a rank "
              f"{[{k: r['counts'][k] for k in kernels} for r in rs]}", flush=True)
    for dtype in ("bfloat16", "float32"):
        vit = get_backbone("dino-s16", dtype=getattr(torch, dtype), device=dev).module.eval()
        with torch.no_grad():
            want = vit(mesh_frames(dev, PP_BATCH))["tokens"].float().cpu()
        del vit
        for nm in PP_MICRO:
            rs = [r[("pp", dtype, nm)] for r in ranks]
            gate = mesh_gate(f"pp {dtype} n_micro {nm}", [r["tokens"] for r in rs], want, dtype)
            n = nm or MESH_WORLD
            ticks = n + MESH_WORLD - 1
            kernels = (("attention_block", "mlp_block") if dtype == "bfloat16" else ())
            for r in rs:
                add_counts(("pp", dtype), r["counts"], totals,
                           {k: 12 // MESH_WORLD * ticks for k in kernels})
            print(f"pp dino-s16 {S} {dtype} batch {PP_BATCH}, dp 1 x pp {MESH_WORLD}, "
                  f"n_micro {n}{' (auto)' if nm is None else ''} ({ticks} ticks, bubble "
                  f"{(MESH_WORLD - 1) / ticks:.3f} of them): {gate}; forward "
                  f"{[round(v, 3) for v in rs[0]['ms']]} / "
                  f"{[round(v, 3) for v in rs[1]['ms']]} ms a rank (host clock); the hops "
                  f"and the output's all-reduce, rank 0: "
                  f"{collective_line(rs[0]['collectives'])}; parameters held "
                  f"{[r['param_bytes'] / 1e6 for r in rs]} MB a rank (blocks "
                  f"{[r['stage'] for r in rs]}) of the whole {rs[0]['whole_bytes'] / 1e6} MB"
                  f" | launches a rank {[{k: r['counts'][k] for k in kernels} for r in rs]}",
                  flush=True)
            if not all(r["param_bytes"] < 0.6 * r["whole_bytes"] for r in rs):
                raise AssertionError("pp: a rank holds more than its stage")
    shutil.rmtree(ranks[0]["dir"], ignore_errors=True)


def run_export_mesh(dev, totals: dict) -> None:
    """The ``export mesh`` phase: each multi-device program of MESH_PROGRAMS
    exported by 2 ranks (``export_work``) and loaded by 2 fresh ranks
    (``load_work``): the round trip against the live mesh forward (max |diff|
    <= 1e-3), each program's features against the one-device program's
    (bf16 per-token cosine >= 0.999), export s, MB a rank beside the
    one-device program's, frames/s of the program and of the live mesh
    forward, one call's launches."""
    import io

    from timetuning_tpu_torch.cli import export as texport

    ex = run_mesh_ranks("export")
    ld = run_mesh_ranks("load", log_dir=ex[0]["dir"])
    print(f"export mesh: {MESH_WORLD} gloo ranks on one card export "
          f"{len(MESH_PROGRAMS)} programs ({ex[0]['wall_s']:.1f} s in all), 2 fresh ranks "
          f"load them ({ld[0]['wall_s']:.1f} s)", flush=True)
    one = {}
    for name, (arch, size, batch, flags) in MESH_PROGRAMS.items():
        moe = {k: v for k, v in flags.items() if k.startswith("moe_")}
        key = (arch, size, batch, tuple(moe.items()))
        if key not in one:
            blob, _, _, _ = texport.export_features(arch, None, batch, size, "bfloat16",
                                                    device=str(dev), **moe)
            with torch.no_grad():
                got = texport.load_exported(io.BytesIO(blob))(export_frames(dev, batch, size))
            one[key] = (len(blob), got.float().cpu())
            del blob
        one_mb, want = one[key][0] / 1e6, one[key][1]
        n_data = flags.get("data_parallel", 1)
        b = batch // n_data
        errs, cos = [], []
        for e, lo in zip(ex, ld):
            e, lo = e[name], lo[name]
            d = lo["coords"][0]
            errs.append(float((lo["tokens"] - e["live"]).abs().max()))
            cos.append(token_cosine(lo["tokens"], want[d * b:(d + 1) * b]))
        mbs = [n / 1e6 for n in ex[0][name]["sizes"]]
        prog_ms = [min(r[name]["ms"]) for r in ld]
        live_ms = [min(r[name]["live_ms"]) for r in ex]
        want_counts = {"tp": {"preprocess": 1},
                       "ep": {"preprocess": 1, "attention_block": 12, "mlp_block": 6},
                       "sp": {"preprocess": 1, "ln_dense": 12, "flash_attention": 12,
                              "dense_residual": 12, "mlp_rows": 12},
                       "pp": {"preprocess": 1, "attention_block": 18, "mlp_block": 18},
                       "dp": {"preprocess": 1, "attention_block": 12, "mlp_block": 12}}[name]
        for r in ld:
            add_counts(("export mesh", name), r[name]["counts"], totals, want_counts)
        print(f"export mesh {name} ({arch} {size} bf16 batch {batch}, "
              f"{' '.join(f'--{k} {v}' for k, v in flags.items())}): export "
              f"{[round(r[name]['export_s'], 2) for r in ex]} s a rank, program "
              f"{[round(v, 1) for v in mbs]} MB a rank (one-device program {one_mb:.1f} MB); "
              f"round trip max |diff| {max(errs):.2e} (gate 1e-3); features vs the one-device "
              f"program min per-token cosine {min(cos):.6f} (gate 0.999); program "
              f"{batch / max(prog_ms) * 1e3:.1f} frames/s ({[round(v, 3) for v in prog_ms]} "
              f"ms a rank), live mesh forward {batch / max(live_ms) * 1e3:.1f} frames/s "
              f"({[round(v, 3) for v in live_ms]} ms a rank; host clock, the ranks in "
              f"step) | one call's launches a rank "
              f"{[{k: r[name]['counts'][k] for k in want_counts} for r in ld]}", flush=True)
        if max(errs) > 1e-3 or min(cos) < 0.999:
            raise AssertionError(f"export mesh {name}: round trip or features")
        if name in ("tp", "pp") and not max(mbs) < one_mb:
            raise AssertionError(f"export mesh {name}: a rank's program is not under the "
                                 "one-device program's")
    shutil.rmtree(ex[0]["dir"], ignore_errors=True)
    shutil.rmtree(ld[0]["dir"], ignore_errors=True)


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
    check_flash_kernels(dev, results)
    check_long_token_kernels(dev, results)
    check_mha_kernels(dev, results)
    check_zoo_kernels(dev, results)
    check_grad(dev, results)
    check_train_kernels(dev, results)
    check_vit(dev, "dino-s16", S, 4)
    check_vit(dev, "dino-s8", S8, 1)

    totals: dict = {}
    run_eval(dev, synthetic_clips(textured=True), "dino-s16", S, totals)
    run_eval(dev, synthetic_clips(textured=True), "dino-s8", S8, totals)
    run_linear_probe(dev, totals)
    default_step = run_train(dev, totals)
    run_train_grad_paths(dev, totals, default_step)
    run_train_f32_against_host(dev, totals)
    run_train_driver(dev, totals)
    run_augment_card_vs_host(dev)
    run_graphs(dev)
    run_eval_driver(dev, totals)
    run_zoo(dev, totals)
    run_cbfe(dev, totals)
    run_propagate_flow(dev, totals)
    check_heads32(dev, results, totals)
    run_export(dev, totals)
    run_parity(dev, totals)
    run_dp(dev, results, totals)
    run_moe(dev, totals)
    run_ep(dev, totals)
    run_tp(dev, totals)
    run_sp_pp(dev, totals)
    run_export_mesh(dev, totals)

    missing = [k for k in kernel_lib.KERNELS if totals.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels launched by no main-path run: {missing}")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "timetuning_tpu"))
    if loaded:
        raise AssertionError(f"modules of JAX or of the JAX package were imported: {loaded}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": totals[name],
         **{key: results[name][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for name, k in kernel_lib.KERNELS.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
