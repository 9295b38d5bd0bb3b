"""TimeT training through the port's driver, ``core/train.run_training``.

Set-up: the clip bank from the seed (``generate``), served through the
port's public ``data/loader.register_dataset`` and ``ClipLoader``; a
``TrainingConfig`` of the cell's configuration and mix, with the run's seed
(the program draws its weights and every step's augmentation from it).
``run_training`` then runs as a user runs it. The benchmark wraps, from
outside, three names the driver looks up when it runs:
``core/train.make_full_step`` (each step is timed on the host and marked in
the trace), ``core/train.save_checkpoint`` (each save) and
``data/loader.device_prefetch`` (each wait for the loader's next batch and
its copy queued).

The first ``warm_steps`` steps are set-up: the first runs eagerly, the
second captures the step's CUDA graph, the third replays it. Their inputs,
losses, the first step's gradient (from the AdamW moment after one update)
and the trained leaves before and after them are kept for the comparison
with the reference. The window opens at the next step's entry and closes at
the first step entry after ``--seconds``; epoch-top saves and loader
restarts that fall inside count. The run then ends through the driver's
own stop path: a SIGTERM to the process, which ``run_training`` answers
by finishing the step in flight, saving and returning.

``run.mode`` (the control and the fault checks; never in a benchmark run):
``control`` steps the reference in fp8 in the program's place,
``fault:half`` gives the program half of each batch, ``fault:unchanged``
skips the program's step.
"""

from __future__ import annotations

import os
import signal
import time

import numpy as np
import torch

from benchmark import compare, counts, generate
from benchmark.reference import timet as ref_timet
from benchmark.reference import vit as ref_vit

_B1 = 0.9


class BankDataset:
    """``videos`` clips for the port's ClipLoader, cycling through the seeded
    bank, in the item layout of its video datasets (one clip a video, its
    native size and its frames' gray means)."""

    def __init__(self, bank, gray, videos: int, native):
        self.bank, self.gray, self.n, self.native = bank, gray, videos, native

    def __len__(self):
        return self.n

    def get_item(self, index: int, epoch: int | None = None) -> dict:
        c = index % len(self.bank)
        F = self.bank.shape[1]
        return {"frames": self.bank[c][None], "annotations": np.zeros((1, F, 1, 1), np.uint8),
                "label": index, "orig_size": np.asarray(self.native, np.int32),
                "gray_means": self.gray[c][None]}


def shape_of(cfg: dict, tr: dict, world: int = 1) -> ref_timet.TrainShape:
    """The reference's shape of the run; over ``world`` data ranks each
    loader holds ceil(videos / world) of the videos."""
    blocks = tuple(int(u.split(".")[1]) for u in cfg["unfreeze_layers"])
    steps = -(-tr["videos"] // world) // tr["batch"]
    return ref_timet.TrainShape(ref_vit.ViTShape.of(cfg), tuple(cfg["head_dims"]),
                                cfg["n_prototypes"], blocks, 1e-4, tr["num_epochs"], steps,
                                cfg["input_size"])


def step_work(cfg: dict, tr: dict, world: int = 1) -> dict:
    """The model operations of one step of the global batch and the least
    time of the ViT blocks' no-grad work (the trunk over every frame, the
    trained blocks over every frame and the teacher's over the first)."""
    B, T, S, P = tr["batch"] * world, tr["frames"], cfg["input_size"], cfg["patch_size"]
    D, hidden = cfg["embed_dim"], int(cfg["embed_dim"] * cfg["mlp_ratio"])
    n_trained = len(cfg["unfreeze_layers"])
    tokens = (S // P) ** 2 + 1
    flops = counts.train_step_flops(B, T, S, P, D, cfg["depth"], hidden,
                                    tuple(cfg["head_dims"]), n_trained, cfg["n_prototypes"],
                                    7, 6, 5)
    least = (counts.blocks_least_s(B * T, tokens, D, hidden, cfg["depth"])
             + counts.blocks_least_s(B, tokens, D, hidden, n_trained))
    return {"flops": flops, "block_least_s": least}


class Recorder:
    """The wrapped step and save: the window, the spans, the set-up steps'
    readings, the stop."""

    def __init__(self, run, warm: int):
        self.run, self.warm = run, warm
        self.k = 0
        self.inputs, self.losses = [], []
        self.snap: dict = {}
        self.stopped = False
        self.window_steps = 0

    def trained(self, state) -> dict:
        return {n: p for n, p in state.model.named_parameters()
                if state.opt.trainable_mask.get(n, False)}

    def wrap_make(self, make):
        def make_timed(*a, **kw):
            full = make(*a, **kw)

            def step(state, frames, sizes, gmeans, generator):
                self.k += 1
                run = self.run
                if self.k == self.warm + 1:
                    run.open_window()
                elif self.k > self.warm + 1 and not self.stopped:
                    if time.perf_counter() - run.lo >= run.seconds:
                        run.close_window()
                        self.window_steps = self.k - self.warm - 1
                        self.stopped = True
                        signal.raise_signal(signal.SIGTERM)
                if self.k <= self.warm:
                    self.inputs.append((frames.cpu(), sizes.cpu(), gmeans.cpu()))
                    if self.k == 1:
                        self.snap["init"] = {n: p.detach().clone()
                                             for n, p in self.trained(state).items()}
                    out = self._warm_step(full, state, frames, sizes, gmeans, generator)
                    self.losses.append(out[1]["loss"])
                    if self.k == 1:
                        # AdamW's first moment after one update is (1 - b1) g
                        moments = state.opt.adamw.state
                        named = state.opt.named_params
                        self.snap["grads"] = {n: moments[named[n]]["exp_avg"] / (1 - _B1)
                                              for n in self.snap["init"]}
                    if self.k == self.warm:
                        self.snap["after"] = {n: p.detach().clone()
                                              for n, p in self.trained(state).items()}
                    return out
                with run.spans.span("step"):
                    return full(state, frames, sizes, gmeans, generator)
            return step
        return make_timed

    def _warm_step(self, full, state, frames, sizes, gmeans, generator):
        mode = self.run.mode
        if mode == "fault:half":
            h = frames.shape[0] // 2
            return full(state, frames[:h], sizes[:h], gmeans[:h], generator)
        if mode == "fault:unchanged":
            state.step += 1
            return state, {"loss": torch.zeros((), device=frames.device), "momentum": 0.0}
        if mode == "control":
            return self.control.stand_in(state, frames, sizes, gmeans, self.k)
        return full(state, frames, sizes, gmeans, generator)

    def wrap_save(self, save):
        def save_timed(*a, **kw):
            with self.run.spans.span("save"):
                return save(*a, **kw)
        return save_timed

    def wrap_prefetch(self, prefetch):
        def prefetch_timed(*a, **kw):
            batches = prefetch(*a, **kw)
            while True:
                with self.run.spans.span("loader"):
                    batch = next(batches, None)
                if batch is None:
                    return
                yield batch
        return prefetch_timed


class Control:
    """The reference in fp8 in the program's place for the set-up steps:
    its losses, first gradient and trained leaves become the readings."""

    def __init__(self, run, shape):
        cfg = run.config
        self.run = run
        init = ref_vit.timet_init(shape.vit, tuple(cfg["head_dims"]), cfg["n_prototypes"],
                                  run.seed)
        self.trainer = ref_timet.Trainer(shape, init, run.device, quant="fp8")

    def stand_in(self, state, frames, sizes, gmeans, k):
        loss = self.trainer.step(frames, sizes, gmeans,
                                 ref_timet.step_generator(self.run.seed, k - 1))
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                if n in self.trainer.names:
                    p.copy_(self.trainer.p[n])
            named = state.opt.named_params
            for n, g in self.trainer.first_grads.items():
                state.opt.adamw.state[named[n]]["exp_avg"].copy_(g * (1 - _B1))
        state.step += 1
        return state, {"loss": torch.tensor(loss), "momentum": 0.0}


def reference_readings(run, shape, inputs, world: int = 1, quant=None) -> dict:
    """The f32 reference (``quant="fp8"``: the control) over the set-up
    steps' inputs, each the global batch of ``world`` ranks' slices."""
    cfg = run.config
    init = ref_vit.timet_init(shape.vit, tuple(cfg["head_dims"]), cfg["n_prototypes"], run.seed)
    tr = ref_timet.Trainer(shape, init, run.device, quant)
    before = {k: tr.p[k].clone() for k in tr.names}
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        losses = [tr.step(f, s, g, [ref_timet.step_generator(run.seed, k, r)
                                    for r in range(world)])
                  for k, (f, s, g) in enumerate(inputs)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return {"losses": losses, "grads": tr.first_grads, "init": before,
            "after": {k: tr.p[k] for k in tr.names}}


def train(run, rec, world: int = 1) -> dict:
    """The clip bank from the seed, the dataset over it, and
    ``core/train.run_training`` of the cell's configuration on
    ``run.device`` under ``rec``'s wraps; ``run_training``'s result."""
    from timetuning_tpu_torch.core import train as ttrain
    from timetuning_tpu_torch.data import loader

    cfg, tr = run.config, run.traffic
    dev = run.device
    bank, _ = generate.clips(run.seed, tr["bank_clips"], tr["frames"], tr["decode_size"],
                             tr["decode_size"], tuple(tr["objects"]), tr["textured"],
                             tr["background"], dev)
    gray = generate.pil_gray_means(bank)
    dataset = f"bench_{run.cell.name}"
    loader.register_dataset(dataset)(
        lambda _n, _root, **_kw: BankDataset(bank, gray, tr["videos"], tr["native_size"]))
    tcfg = ttrain.TrainingConfig(
        architecture=cfg["architecture"], dataset=dataset, data_root=str(tr["videos"]),
        log_dir=os.path.join(run.work_dir, "logs"), batch_size=tr["batch"],
        num_epochs=tr["num_epochs"], num_workers=tr["num_workers"],
        num_clusters=cfg["n_prototypes"], input_resolution=cfg["input_size"],
        compute_dtype=cfg["dtype"], num_frames=tr["frames"], decode_size=tr["decode_size"],
        head_dims=tuple(cfg["head_dims"]), unfreeze_layers=tuple(cfg["unfreeze_layers"]),
        seed=run.seed, use_tensorboard=False, handle_preemption=True,
        device=str(dev), num_devices=world)
    make, save, prefetch = ttrain.make_full_step, ttrain.save_checkpoint, loader.device_prefetch
    ttrain.make_full_step, ttrain.save_checkpoint = rec.wrap_make(make), rec.wrap_save(save)
    loader.device_prefetch = rec.wrap_prefetch(prefetch)
    try:
        return ttrain.run_training(tcfg)
    finally:
        ttrain.make_full_step, ttrain.save_checkpoint = make, save
        loader.device_prefetch = prefetch


def run(run) -> dict:
    from benchmark import harness

    cfg, tr = run.config, run.traffic
    dev = run.device
    shape = shape_of(cfg, tr)
    rec = Recorder(run, tr["warm_steps"])
    if run.mode == "control":
        rec.control = Control(run, shape)
    out = train(run, rec)
    if not rec.stopped:
        raise RuntimeError(f"the run ended after {rec.k} steps, before its window closed")
    device = harness.card_facts(torch, 1) if dev.type == "cuda" else {}
    trace = run.trace_facts()
    prog = {"losses": [float(x) for x in rec.losses], "grads": rec.snap["grads"],
            "init": rec.snap["init"], "after": rec.snap["after"]}
    del out
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(run, shape, rec.inputs)
    numbers = compare.train_numbers(prog, ref)
    clips = rec.window_steps * tr["batch"]
    lo, hi = run.lo, run.hi
    work = step_work(cfg, tr)
    facts = {"window_s": run.window_s, "steps": rec.window_steps, "clips": clips,
             "stall_s": run.spans.total_s("loader", lo, hi) + run.spans.total_s("save", lo, hi),
             "loader_s": run.spans.total_s("loader", lo, hi),
             "step_s": run.spans.total_s("step", lo, hi),
             "saves_ms": [1e3 * (b - a) for a, b in run.spans.inside("save", lo, hi)],
             "trace": trace, "flops_per_step": work["flops"],
             "block_least_s": work["block_least_s"], "chips": 1}
    return {"attempted": clips, "failed": 0, "correct": True,
            "e2e": {"train_clips_per_s": clips / run.window_s, "setup_s": run.setup_s},
            "facts": facts, "numbers": numbers, "device": device,
            "readings": {"program": prog["losses"], "reference": ref["losses"]}}
