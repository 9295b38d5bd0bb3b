"""Dense features of DINOv3 ViT-7B/16, its first ``depth`` blocks, from the
port's serving program: ``cli/export`` of ``dinov3-vit7b16``.

As ``serve_export_dinov2`` (set-up, window, check), with the DINOv3
reference: the weights from the seed in the hub checkpoint's layout
(``reference/dinov3.seeded_weights``, LayerScale drawn away from 1), the
program exported at the configuration's ``depth`` and loaded with
``load_exported(graphed=True)``, one client in a closed loop, the sampled
requests' features recomputed by the f32 reference after the window. A port
without the configuration fails at once, before any weight is made.

``run.mode``: ``control`` puts the reference in fp8 in the program's place
for the compared requests; ``fault:no_rope``, ``fault:rope_on_prefix`` and
``fault:no_layerscale`` the f32 reference with that fault
(``reference/dinov3.FAULTS``); ``fault:altered`` negates one token of each
kept answer; ``readings`` reports the program's gap and, beside it under
``readings``, the control's and each fault's on the same requests (one
set-up for all of them).

The facts carry the work a request (``counts_dinov3``: the model's
operations; the blocks', the flash core's, the LayerNorm pass's, the RoPE
qkv tile's and the SwiGLU tile's least times) and the launches a request of the entries a block runs, counted by
the port (``ln_rope_dense``, ``flash_d128``, ``swiglu_mlp``,
``dense_residual``: one each a block).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark import compare, counts_dinov2, counts_dinov3, generate
from benchmark.reference import dinov3 as ref

ENTRIES = ("ln_rope_dense", "flash_d128", "swiglu_mlp", "dense_residual")


def request_work(cfg: dict, frames: int) -> dict:
    S, P, D = cfg["input_size"], cfg["patch_size"], cfg["embed_dim"]
    H, R, depth = cfg["ffn_hidden"], cfg["n_storage_tokens"], cfg["depth"]
    T = counts_dinov3.tokens(S, P, R)
    patches, Dh = (S // P) ** 2, D // cfg["num_heads"]
    rows = frames * T
    return {"flops": frames * counts_dinov3.vit_flops(S, P, D, depth, H, R),
            "blocks_least_s_v3": counts_dinov3.blocks_least_s(frames, T, D, H, depth,
                                                              patches, Dh),
            "attn128_least_s": depth * counts_dinov3.attn_least_s(frames, T, D),
            "ln4096_least_s": 2 * depth * counts_dinov3.ln_least_s(rows, D),
            "qkv_rope_least_s": depth * counts_dinov3.qkv_rope_least_s(rows, D, patches, Dh),
            "swiglu_least_s": depth * counts_dinov2.swiglu_least_s(rows, D, H)}


def check_port(architecture: str) -> None:
    """Raise at once where the port has no such backbone (a tree older than
    the configuration)."""
    from timetuning_tpu_torch.models import registry

    names = getattr(registry, "ALL_ARCHITECTURES", registry.ARCHITECTURES)
    if architecture not in names:
        raise SystemExit(f"serve_export_dinov3: the port has no backbone {architecture!r}")


def export_program(run, weights: dict, batch: int):
    """The loaded serving program of the seeded weights, the configuration's
    first ``depth`` blocks."""
    from timetuning_tpu_torch.cli.export import export_features, load_exported

    cfg = run.config
    pth = os.path.join(run.work_dir, "backbone.pth")
    torch.save({k: v.cpu() for k, v in weights.items()}, pth)
    blob, live, _, _ = export_features(cfg["architecture"], pth, batch_size=batch,
                                       input_resolution=cfg["input_size"],
                                       compute_dtype=cfg["dtype"], device=str(run.device),
                                       depth=cfg["depth"])
    del live
    os.remove(pth)
    program = os.path.join(run.work_dir, "features.pt2")
    with open(program, "wb") as f:
        f.write(blob)
    del blob
    return load_exported(program, graphed=True)


def launch_counts() -> dict:
    from timetuning_tpu_torch.ops import kernel_lib

    return kernel_lib.launch_counts()


def run(run) -> dict:
    from benchmark import harness

    cfg, tr = run.config, run.traffic
    check_port(cfg["architecture"])
    dev = run.device
    shape = ref.DinoV3Shape.of(cfg)
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
    before = launch_counts()
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
    after = launch_counts()
    if not kept:
        kept.append(last)           # a short window: its last answer
    device = harness.card_facts(torch, 1) if dev.type == "cuda" else {}
    trace = run.trace_facts()
    del serve
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    pick = rng.permutation(len(kept))[:tr["compare"]]
    mean, std = cfg["normalize_mean"], cfg["normalize_std"]
    size = cfg["input_size"]
    modes = (("control",) + tuple(f"fault:{f}" for f in ref.FAULTS)
             if run.mode == "readings" else ())
    gaps, others = [], {m: [] for m in modes}
    for j in pick:
        c, got = kept[j]
        frames = torch.from_numpy(bank[c]).to(dev)
        want = ref.features_u8(weights, frames, shape, size, mean, std)
        for m in modes:
            others[m].append(compare.token_gap(_answer(m, weights, frames, shape, size, mean,
                                                       std, got), want))
        if run.mode not in (None, "readings"):
            got = _answer(run.mode, weights, frames, shape, size, mean, std, got)
        gaps.append(compare.token_gap(got, want))
    n = len(lat)
    work = request_work(cfg, tr["frames"])
    facts = {"window_s": run.window_s, "requests": n, "trace": trace,
             "flops_per_request": work["flops"], "chips": 1,
             "blocks_least_s_v3": work["blocks_least_s_v3"],
             "attn128_least_s": work["attn128_least_s"],
             "ln4096_least_s": work["ln4096_least_s"],
             "qkv_rope_least_s": work["qkv_rope_least_s"],
             "swiglu_least_s": work["swiglu_least_s"]}
    for name in ENTRIES:
        facts[f"{name}_launches_per_request"] = (
            (after.get(name, 0) - before.get(name, 0)) / max(n, 1))
    out = {"attempted": n, "failed": 0, "correct": len(gaps) > 0,
           "e2e": {"frames_per_s": n * tr["frames"] / run.window_s,
                   "request_ms_p95": 1e3 * harness.percentile(lat, 95),
                   "setup_s": run.setup_s},
           "facts": facts, "numbers": {"token_gap": max(gaps) if gaps else float("inf")},
           "device": device}
    if modes:
        out["readings"] = {m: max(v) for m, v in others.items()}
    return out


def _answer(mode: str, weights, frames, shape, size, mean, std, got):
    """What the program's place holds under a control or fault ``mode``."""
    if mode == "control":
        return ref.features_u8(weights, frames, shape, size, mean, std, quant="fp8")
    if mode == "fault:altered":
        got = got.clone()
        got[0, 0] = -got[0, 0]
        return got
    fault = mode.split(":", 1)[1]
    if fault not in ref.FAULTS:
        raise ValueError(f"serve_export_dinov3: unknown mode {mode!r}")
    return ref.features_u8(weights, frames, shape, size, mean, std, fault=fault)
