"""Dense features from the port's serving program: ``cli/export``.

Set-up: the ViT's weights from the seed, made on the card by the benchmark
(``reference/vit.seeded_weights``) and written under the run's temporary
directory as a reference-layout ``.pth``; ``cli/export.export_features``
builds and exports the uint8 -> features program at the mix's batch, which
is saved beside it and loaded with ``cli/export.load_exported(graphed=True)``
(one CUDA graph a batch shape); the clip bank from the seed; the program
called ``warm_calls`` times (eager, capture, replay).

The window: one client in a closed loop. A request is a clip of host
uint8 frames; it runs from the hand-over of the frames, through the
pageable copy to the card and the program, to its features on the card
after a synchronise. Requests sampled from the seed keep their features
(the last request's when a short window sampled none);
after the window the plain reference recomputes them in f32 from the same
weights and frames.

``run.mode``: ``control`` puts the reference in fp8 in the program's place
for the compared requests; ``fault:altered`` negates one token of each
kept answer.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark import compare, counts, generate
from benchmark.reference import dense as ref_dense
from benchmark.reference import vit as ref_vit


def request_work(cfg: dict, frames: int) -> dict:
    S, P, D = cfg["input_size"], cfg["patch_size"], cfg["embed_dim"]
    hidden = int(D * cfg["mlp_ratio"])
    tokens = (S // P) ** 2 + 1
    return {"flops": frames * counts.vit_flops(S, P, D, cfg["depth"], hidden),
            "block_least_s": counts.blocks_least_s(frames, tokens, D, hidden, cfg["depth"])}


def export_program(run, weights: dict, batch: int):
    """The loaded serving program of the seeded weights."""
    from timetuning_tpu_torch.cli.export import export_features, load_exported

    cfg = run.config
    pth = os.path.join(run.work_dir, "backbone.pth")
    torch.save({k: v.cpu() for k, v in weights.items()}, pth)
    blob, live, _, _ = export_features(cfg["architecture"], pth, batch_size=batch,
                                       input_resolution=cfg["input_size"],
                                       compute_dtype=cfg["dtype"], device=str(run.device))
    del live
    program = os.path.join(run.work_dir, "features.pt2")
    with open(program, "wb") as f:
        f.write(blob)
    return load_exported(program, graphed=True)


def run(run) -> dict:
    from benchmark import harness

    cfg, tr = run.config, run.traffic
    dev = run.device
    shape = ref_vit.ViTShape.of(cfg)
    weights = ref_vit.seeded_weights(shape, run.seed, dev)
    serve = export_program(run, weights, tr["frames"])
    bank, _ = generate.clips(run.seed, tr["bank_clips"], tr["frames"], tr["height"],
                             tr["width"], tuple(tr["objects"]), tr["textured"],
                             tr["background"], dev)
    rng = np.random.default_rng([run.seed % (2 ** 63), 0x5A4D])
    for _ in range(tr["warm_calls"]):
        serve(torch.from_numpy(bank[0]).to(dev))
    order = generate.order(run.seed, len(bank), 1 << 16)
    lat, kept = [], []
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
    if not kept:
        kept.append(last)           # a short window: its last answer
    device = harness.card_facts(torch, 1) if dev.type == "cuda" else {}
    trace = run.trace_facts()
    del serve
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    pick = rng.permutation(len(kept))[:tr["compare"]]
    gaps = []
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for j in pick:
            c, got = kept[j]
            frames = torch.from_numpy(bank[c]).to(dev)
            want = ref_dense.features(weights, frames, shape, cfg["input_size"],
                                      cfg["normalize_mean"], cfg["normalize_std"])
            if run.mode == "control":
                got = ref_dense.features(weights, frames, shape, cfg["input_size"],
                                         cfg["normalize_mean"], cfg["normalize_std"],
                                         quant="fp8")
            elif run.mode == "fault:altered":
                got = got.clone()
                got[0, 0] = -got[0, 0]
            gaps.append(compare.token_gap(got, want))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    n = len(lat)
    work = request_work(cfg, tr["frames"])
    facts = {"window_s": run.window_s, "requests": n, "trace": trace,
             "flops_per_request": work["flops"], "block_least_s": work["block_least_s"],
             "chips": 1}
    return {"attempted": n, "failed": 0, "correct": len(gaps) > 0,
            "e2e": {"frames_per_s": n * tr["frames"] / run.window_s,
                    "request_ms_p95": 1e3 * harness.percentile(lat, 95),
                    "setup_s": run.setup_s},
            "facts": facts, "numbers": {"token_gap": max(gaps) if gaps else float("inf")},
            "device": device}
