"""Dense features of DINOv2 ViT-g/14 with registers from the port's serving
program: ``cli/export`` of ``dinov2-g14-reg``.

As ``serve_export`` (set-up, window, check), with the DINOv2 reference:
the weights from the seed in the hub checkpoint's layout
(``reference/dinov2.seeded_weights``, LayerScale drawn away from 1), the
program exported and loaded with ``load_exported(graphed=True)``, one client
in a closed loop, the sampled requests' features recomputed by the f32
reference after the window. A port without the configuration fails at once,
before any weight is made.

``run.mode``: ``control`` puts the reference in fp8 in the program's place
for the compared requests; ``fault:no_layerscale`` and
``fault:no_registers`` the f32 reference without LayerScale or without the
registers; ``fault:altered`` negates one token of each kept answer.

The facts carry the work a request (``counts_dinov2``: the model's
operations; the blocks', the SwiGLU tile's and the LayerNorm pass's least
times) and the launches a request of the DINOv2 entries, counted by the
port (``ln_wide_dense``, ``swiglu_mlp``: one each a block).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, counts_dinov2, generate
from benchmark.drivers.serve_export import export_program
from benchmark.reference import dinov2 as ref

ENTRIES = ("ln_wide_dense", "swiglu_mlp")


def request_work(cfg: dict, frames: int) -> dict:
    S, P, D = cfg["input_size"], cfg["patch_size"], cfg["embed_dim"]
    H, R, depth = cfg["ffn_hidden"], cfg["n_registers"], cfg["depth"]
    T = counts_dinov2.tokens(S, P, R)
    rows = frames * T
    return {"flops": frames * counts_dinov2.vit_flops(S, P, D, depth, H, R),
            "blocks_least_s_g14": counts_dinov2.blocks_least_s(frames, T, D, H, depth),
            "swiglu_least_s": depth * counts_dinov2.swiglu_least_s(rows, D, H),
            "ln_wide_least_s": 2 * depth * counts_dinov2.ln_wide_least_s(rows, D)}


def check_port(architecture: str) -> None:
    """Raise at once where the port has no such backbone (a tree older than
    the configuration)."""
    from timetuning_tpu_torch.models import registry

    names = getattr(registry, "ALL_ARCHITECTURES", registry.ARCHITECTURES)
    if architecture not in names:
        raise SystemExit(f"serve_export_dinov2: the port has no backbone {architecture!r}")


def launch_counts() -> dict:
    from timetuning_tpu_torch.ops import kernel_lib

    return kernel_lib.launch_counts()


def run(run) -> dict:
    from benchmark import harness

    cfg, tr = run.config, run.traffic
    check_port(cfg["architecture"])
    dev = run.device
    shape = ref.DinoV2Shape.of(cfg)
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
    gaps = []
    for j in pick:
        c, got = kept[j]
        frames = torch.from_numpy(bank[c]).to(dev)
        want = ref.features_u8(weights, frames, shape, cfg["input_size"], mean, std)
        if run.mode == "control":
            got = ref.features_u8(weights, frames, shape, cfg["input_size"], mean, std,
                                  quant="fp8")
        elif run.mode == "fault:no_layerscale":
            got = ref.features_u8(weights, frames, shape, cfg["input_size"], mean, std,
                                  layerscale=False)
        elif run.mode == "fault:no_registers":
            got = ref.features_u8(weights, frames, shape, cfg["input_size"], mean, std,
                                  registers=False)
        elif run.mode == "fault:altered":
            got = got.clone()
            got[0, 0] = -got[0, 0]
        gaps.append(compare.token_gap(got, want))
    n = len(lat)
    work = request_work(cfg, tr["frames"])
    facts = {"window_s": run.window_s, "requests": n, "trace": trace,
             "flops_per_request": work["flops"], "chips": 1,
             "blocks_least_s_g14": work["blocks_least_s_g14"],
             "swiglu_least_s": work["swiglu_least_s"],
             "ln_wide_least_s": work["ln_wide_least_s"]}
    for name in ENTRIES:
        facts[f"{name}_launches_per_request"] = (
            (after.get(name, 0) - before.get(name, 0)) / max(n, 1))
    return {"attempted": n, "failed": 0, "correct": len(gaps) > 0,
            "e2e": {"frames_per_s": n * tr["frames"] / run.window_s,
                    "request_ms_p95": 1e3 * harness.percentile(lat, 95),
                    "setup_s": run.setup_s},
            "facts": facts, "numbers": {"token_gap": max(gaps) if gaps else float("inf")},
            "device": device}
