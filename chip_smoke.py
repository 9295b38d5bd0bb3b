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
   of 480x854; kernel 4 also to ViT-S/8's 448), kernels 1 and 2 also at the
   train step's 128 frames, kernel 1 at 8 x 577 tokens (its core's two
   passes), kernel 7 also at kernel 1's
   9,850 rows; the bf16 hidden of kernels 2 and 9 against the plain hidden,
   and their two launches (fc1 + GELU, fc2) timed apart;
   the flash kernel in bf16 and f32 at [4 x 6 heads, 3,137
   tokens, 64], at queries != keys with a key mask, and in bf16 at the eval
   group's own 50 frames; the row kernels (ln_dense, dense_residual,
   mlp_rows) at 50 frames x 3,137 tokens; the propagation kernel (kernel 3)
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
   channels;
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
   assignment) against the same step on the host (the matvec form).

Beside each kernel's time the script prints the least time the card could
take for the same work (``bound_ms``: the larger of its bytes, each input
read and each output written once, over 3.35 TB/s, and its operations over
the published peak of their type, 989 TFLOP/s bf16 or 67 TFLOP/s f32) and,
where PyTorch has library calls for the same function, their time
(``library_ms``; measured here, used nowhere in the port). Kernel, plain and
library times are device times: the timed launches are queued behind a
device-side sleep, so a slow host does not show in them.

Launch counts are set to 0 just before each main-path run (phases 5 to 8)
and read just after; each run must launch the kernels of its path, and the
sums over all runs are the ``launches`` of the kernels line. The last lines
are a JSON object of per-kernel results, the card's ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

CLIPS, FRAMES, H, W, S = 2, 25, 480, 854, 224
S8 = 448                            # ViT-S/8 input: 56x56 patches, 3,137 tokens
TRAIN_B, TRAIN_F = 32, 4            # the train step's clips and frames a clip
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


def check_long_token_kernels(dev, results: dict) -> None:
    """The row kernels and the propagation kernel of the ViT-S/8 at 448
    path, at its shapes."""
    from timetuning_tpu_torch.ops import fused_block as fb

    rng = np.random.default_rng(8)
    t, w = _tensor_maker(dev, rng)
    report = _reporter(results)
    T8 = (S8 // 8) ** 2 + 1

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
    M = B * T8
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
               extra=f"[{B}, {T8}, {D}] ",
               work=(io_bytes(*args, got), flops, "bf16"),
               library_ms=cuda_ms(lib))
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with plain version")
        del got, want
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
    # composition in bf16: one bf16 ulp apart). K1 and K2 also at the train
    # step's 128 frames, K1 at a two-pass length of its core (8 x 577 tokens,
    # ViT-S/16 at 384); K7 at K1's own rows (9,850: 77 row blocks on the card's
    # SMs); K2's bf16 hidden against the plain hidden, its two launches apart
    def check_block(name, key, kern, plain, x, wts, flops, lib):
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
    for b, s in ((TRAIN_B * TRAIN_F, T), (8, 577)):
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
        with dense_pass_rows() as k3:
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

        ms = cuda_ms(group, warmup=1, reps=5, queued=False)
        s = scores[dtype]
        print(f"eval {arch}/{size} {dtype}: J={s['J']:.6f} F={s['F']:.6f} "
              f"J&F={s['J&F']:.6f} | evaluate_clips (with host J&F) "
              f"{wall * 1e3:.1f} ms = {n / wall:.1f} frames/s | device compute "
              f"{ms:.2f} ms per {CLIPS}-clip group = {n / ms * 1e3:.1f} frames/s "
              f"| launches {counts}", flush=True)
        dense_pass_line(f"eval {arch}/{size} {dtype}", k3)
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


def build_train(dev, dtype, attn_impl: str = "auto", seed: int = 0):
    """The reference's flagship at full width (time_tuning.py:573-577): DINO
    ViT-S/16 at 224, head [1024, 1024, 512, 256], 200 prototypes, seeded
    random weights; blocks 10 and 11, the head and the prototypes trainable
    over a shared frozen trunk of 10 blocks, AdamW over the trainable
    subtree."""
    from timetuning_tpu_torch.core.optimizer import swav_optimizer
    from timetuning_tpu_torch.core.timet import (
        TimeT,
        TimeTConfig,
        init_state,
        make_train_step,
    )
    from timetuning_tpu_torch.models.extractor import FeatureExtractor
    from timetuning_tpu_torch.models.vit import VisionTransformer, vit_small

    vit = VisionTransformer(vit_small(16, img_size=S, dtype=dtype, attn_impl=attn_impl))
    model = TimeT(FeatureExtractor(vit, 384, (1024, 1024, 512, 256)), 200)
    model.init_weights(torch.Generator().manual_seed(seed)).to(dev)
    cfg = TimeTConfig(n_prototypes=200, use_teacher=True, frozen_trunk_blocks=10,
                      n_last_frames=7, size_mask_neighborhood=6, topk=5,
                      num_epochs=1, steps_per_epoch=100, spatial_resolution=S // 16)
    opt, mask = swav_optimizer(model, lr=1e-4, num_epochs=1, steps_per_epoch=100,
                               opt_over_trainable=True)
    state = init_state(model, cfg, opt, trainable_mask=mask)
    step = make_train_step(model, cfg, opt, trainable_mask=mask,
                           opt_over_trainable=True)
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
        state.opt.adamw.step()
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


def run_train(dev, totals: dict) -> None:
    """Phases 7 and 8: the train step in its two configurations at full
    width, and kernel 11 on a real step's scores."""
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
    check_train_kernels(dev, results)
    check_vit(dev, "dino-s16", S, 4)
    check_vit(dev, "dino-s8", S8, 1)

    totals: dict = {}
    run_eval(dev, synthetic_clips(textured=True), "dino-s16", S, totals)
    run_eval(dev, synthetic_clips(textured=True), "dino-s8", S8, totals)
    run_linear_probe(dev, totals)
    run_train(dev, totals)
    run_train_f32_against_host(dev, totals)

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
