"""Dense image embeddings of SAM ViT-H's image encoder from the port's
serving program: ``cli/export`` of ``sam-vit-h``.

As ``serve_export_dinov3`` (set-up, window, check), with the SAM reference:
the weights from the seed in the release checkpoint's layout
(``reference/sam.seeded_weights``: the relative-position tables and the qkv
bias drawn away from 0), the whole encoder exported and loaded with
``load_exported(graphed=True)``, one client in a closed loop, the sampled
requests' features (the neck's 256-wide tokens of the 64 x 64 grid)
recomputed by the f32 reference after the window. A port without the
architecture fails at once, before any weight is made.

``run.mode``: ``control`` puts the reference in fp8 in the program's place
for the compared requests; ``fault:no_relpos``, ``fault:all_global``,
``fault:pad_masked``, ``fault:relpos_swapped`` and ``fault:pad_before_norm``
the f32 reference with that fault (``reference/sam.FAULTS``);
``fault:altered`` negates one token of each kept answer; ``readings``
reports the program's gap and, beside it under ``readings``, the control's
and each fault's on the same requests (one set-up for all of them).

The facts carry the work a request (``counts_sam``: the model's operations
as SAM computes them; the blocks', the heads-of-80 core's and the GELU MLP's
least times; the LayerNorm pass's, ``ln_wide_rows_kernel`` in LN1 of each
global block and LN2 of every block, as ``counts_dinov2`` counts it), the
launches a request of the entries the blocks run, counted
by the port (``ln_window_dense`` in each windowed block, ``ln_wide_dense``
in each global one, ``flash_relpos``, ``dense_residual`` and ``mlp_wide``
in every block), and the port's work counts a request (``relpos_windows``,
``relpos_global``, ``window_pad_rows``), each zero on a port without them.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark import compare, counts_dinov2, counts_sam, generate
from benchmark.reference import sam as ref

ENTRIES = ("ln_window_dense", "ln_wide_dense", "flash_relpos", "dense_residual", "mlp_wide")
WORK = ("relpos_windows", "relpos_global", "window_pad_rows")


def request_work(cfg: dict, frames: int) -> dict:
    S, P, D = cfg["input_size"], cfg["patch_size"], cfg["embed_dim"]
    H, depth, win = cfg["mlp_hidden"], cfg["depth"], cfg["window_size"]
    glob = tuple(cfg["global_attn_indexes"])
    g = counts_sam.grid(S, P)
    return {"flops": frames * counts_sam.model_flops(S, P, D, H, depth, win, glob,
                                                     cfg["out_chans"]),
            "blocks_least_s_samh": counts_sam.blocks_least_s(frames, S, P, D, H, depth, win,
                                                             glob),
            "attn80_least_s": counts_sam.attn_least_s(frames, S, P, D, depth, win, glob),
            "gelu_wide_least_s": depth * counts_sam.gelu_mlp_least_s(frames * g * g, D, H),
            "ln_wide_least_s": (depth + len(glob)) * counts_dinov2.ln_wide_least_s(
                frames * g * g, D)}


def check_port(architecture: str) -> None:
    """Raise at once where the port has no such backbone (a tree older than
    the configuration)."""
    from timetuning_tpu_torch.models import registry

    names = getattr(registry, "ALL_ARCHITECTURES", registry.ARCHITECTURES)
    if architecture not in names:
        raise SystemExit(f"serve_export_sam: the port has no backbone {architecture!r}")


def export_program(run, weights: dict, batch: int):
    """The loaded serving program of the seeded weights."""
    from timetuning_tpu_torch.cli.export import export_features, load_exported

    cfg = run.config
    pth = os.path.join(run.work_dir, "sam.pth")
    torch.save({k: v.cpu() for k, v in weights.items()}, pth)
    blob, live, _, _ = export_features(cfg["architecture"], pth, batch_size=batch,
                                       input_resolution=cfg["input_size"],
                                       compute_dtype=cfg["dtype"], device=str(run.device))
    del live
    os.remove(pth)
    program = os.path.join(run.work_dir, "features.pt2")
    with open(program, "wb") as f:
        f.write(blob)
    del blob
    return load_exported(program, graphed=True)


def port_counts() -> dict:
    """The port's launch counts and, where it keeps them, its work counts."""
    from timetuning_tpu_torch.ops import kernel_lib

    counts = getattr(kernel_lib, "counts", kernel_lib.launch_counts)
    return counts()


def run(run) -> dict:
    from benchmark import harness

    cfg, tr = run.config, run.traffic
    check_port(cfg["architecture"])
    dev = run.device
    shape = ref.SamShape.of(cfg)
    weights = ref.seeded_weights(shape, run.seed, dev)
    serve = export_program(run, weights, tr["frames"])
    bank, _ = generate.clips(run.seed, tr["bank_clips"], tr["frames"], tr["height"],
                             tr["width"], tuple(tr["objects"]), tr["textured"],
                             tr["background"], dev)
    rng = np.random.default_rng([run.seed % (2 ** 63), 0x5A4D])
    for _ in range(tr["warm_calls"]):
        serve(torch.from_numpy(bank[0]).to(dev))
    order = generate.order(run.seed, len(bank), 1 << 16)
    lat, kept = [], []
    before = port_counts()
    run.open_window()
    i = 0
    while time.perf_counter() - run.lo < run.seconds:
        clip = bank[order[i]]
        t0 = time.perf_counter()
        with run.spans.span("request"):
            with run.spans.span("copy"):
                x = torch.from_numpy(clip).to(dev)
            out = serve(x)
            run.sync()
        lat.append(time.perf_counter() - t0)
        last = (int(order[i]), out)
        if len(kept) < tr["sample_keep"] and rng.random() < tr["sample_p"]:
            kept.append(last)
        i += 1
    run.close_window()
    after = port_counts()
    if not kept:
        kept.append(last)           # a short window: its last answer
    device = harness.card_facts(torch, 1) if dev.type == "cuda" else {}
    trace = run.trace_facts()
    del serve
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    pick = rng.permutation(len(kept))[:tr["compare"]]
    mean, std = cfg["normalize_mean"], cfg["normalize_std"]
    modes = (("control",) + tuple(f"fault:{f}" for f in ref.FAULTS)
             if run.mode == "readings" else ())
    gaps, others = [], {m: [] for m in modes}
    for j in pick:
        c, got = kept[j]
        frames = torch.from_numpy(bank[c]).to(dev)
        want = ref.features_u8(weights, frames, shape, mean, std)
        for m in modes:
            others[m].append(compare.token_gap(_answer(m, weights, frames, shape, mean, std,
                                                       got), want))
        if run.mode not in (None, "readings"):
            got = _answer(run.mode, weights, frames, shape, mean, std, got)
        gaps.append(compare.token_gap(got, want))
    n = len(lat)
    work = request_work(cfg, tr["frames"])
    facts = {"window_s": run.window_s, "requests": n, "trace": trace,
             "flops_per_request": work["flops"], "chips": 1,
             "blocks_least_s_samh": work["blocks_least_s_samh"],
             "attn80_least_s": work["attn80_least_s"],
             "gelu_wide_least_s": work["gelu_wide_least_s"],
             "ln_wide_least_s": work["ln_wide_least_s"]}
    for name in ENTRIES:
        facts[f"{name}_launches_per_request"] = (
            (after.get(name, 0) - before.get(name, 0)) / max(n, 1))
    for name in WORK:
        facts[f"{name}_per_request"] = (after.get(name, 0) - before.get(name, 0)) / max(n, 1)
    out = {"attempted": n, "failed": 0, "correct": len(gaps) > 0,
           "e2e": {"frames_per_s": n * tr["frames"] / run.window_s,
                   "request_ms_p95": 1e3 * harness.percentile(lat, 95),
                   "setup_s": run.setup_s},
           "facts": facts, "numbers": {"token_gap": max(gaps) if gaps else float("inf")},
           "device": device}
    if modes:
        out["readings"] = {m: max(v) for m, v in others.items()}
    return out


def _answer(mode: str, weights, frames, shape, mean, std, got):
    """What the program's place holds under a control or fault ``mode``."""
    if mode == "control":
        return ref.features_u8(weights, frames, shape, mean, std, quant="fp8")
    if mode == "fault:altered":
        got = got.clone()
        got[0, 0] = -got[0, 0]
        return got
    fault = mode.split(":", 1)[1]
    if fault not in ref.FAULTS:
        raise ValueError(f"serve_export_sam: unknown mode {mode!r}")
    return ref.features_u8(weights, frames, shape, mean, std, fault=fault)
