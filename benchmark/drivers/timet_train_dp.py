"""TimeT training over data-parallel ranks, as ``cli/train --multihost``
runs it under ``torchrun``: one process a card, the environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
read by ``parallel/mesh.init_from_env`` (NCCL on the cards), and
``core/train.run_training`` on every rank.

This process is rank 0: it starts the other ranks (this file run as a
script, one process each), joins the group, and runs the one-card
driver's set-up and window (``timet_train``) with ``batch`` clips a rank,
the global batch ``batch`` x ranks. Its clock, spans and trace are the
run's. The window ends as in the one-card driver: rank 0 sends itself a
SIGTERM, and ``run_training``'s preemption path, which the ranks agree on
every 20 batches, stops every rank at one step.

Each rank keeps its first ``warm_steps`` batches; rank 0 reads the others'
from the run's directory once they have ended, and the reference follows
the global batch, the ranks' slices in rank order, each slice augmented
with its own rank's draws. The gradients are averaged over the ranks and
K11 takes its column sums over them, so the global step is the reference's
one-device step.

``run.mode``: ``control`` reads the reference in fp8 against it on the same
batches; ``fault:exchange`` leaves out the ranks' gradient all-reduce
(``core/timet._mean_over_group``); ``fault:half`` gives every rank half of
each set-up batch (the other ranks every batch).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch

from benchmark import compare, harness

base = harness.load_module(harness.HERE / "drivers" / "timet_train.py", "driver_timet_train")

JOIN_S = 300            # a rank that has not ended by then is killed


class Follower:
    """The wraps of a rank other than 0: it keeps its set-up steps' inputs
    and times nothing."""

    def __init__(self, warm: int):
        self.warm, self.k, self.inputs = warm, 0, []

    def wrap_make(self, make):
        def make_kept(*a, **kw):
            full = make(*a, **kw)

            def step(state, frames, sizes, gmeans, generator):
                self.k += 1
                if self.k <= self.warm:
                    self.inputs.append((frames.cpu(), sizes.cpu(), gmeans.cpu()))
                return full(state, frames, sizes, gmeans, generator)
            return step
        return make_kept

    def wrap_save(self, save):
        return save

    def wrap_prefetch(self, prefetch):
        return prefetch


class Faults:
    """A planted fault, in place while open, on every rank."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        from timetuning_tpu_torch.core import timet

        self.kept = timet._mean_over_group
        if self.mode == "fault:exchange":
            timet._mean_over_group = lambda grads, scalars, group: (grads, list(scalars))
        return self

    def __exit__(self, *exc):
        from timetuning_tpu_torch.core import timet

        timet._mean_over_group = self.kept


def _half(rec):
    """``fault:half``: the step given the first half of each batch."""
    make = rec.wrap_make

    def wrap_make(m):
        def make_half(*a, **kw):
            full = m(*a, **kw)

            def step(state, frames, sizes, gmeans, generator):
                h = frames.shape[0] // 2
                return full(state, frames[:h], sizes[:h], gmeans[:h], generator)
            return step
        return make(make_half)
    rec.wrap_make = wrap_make


def _join_group(rank: int, world: int, port: int, device: torch.device):
    from timetuning_tpu_torch.parallel.mesh import init_from_env

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    return init_from_env(device if device.type == "cpu" else None, timeout_s=JOIN_S)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_file(work_dir: str, rank: int) -> str:
    return os.path.join(work_dir, f"rank{rank}.pt")


def run(run) -> dict:
    import torch.distributed as dist

    cfg, tr = run.config, run.traffic
    world = int(run.cell.workload["chips"])
    port = _free_port()
    cell_file = os.path.join(run.work_dir, "cell.json")
    with open(cell_file, "w") as f:
        json.dump({"workload": run.cell.workload, "config": cfg, "traffic": tr}, f)
    workers = [subprocess.Popen(
        [sys.executable, __file__, "--cell", cell_file, "--rank", str(r),
         "--world", str(world), "--port", str(port), "--seed", str(run.seed),
         "--work-dir", run.work_dir, "--mode", str(run.mode),
         "--device", run.device.type])
        for r in range(1, world)]
    mode = run.mode
    try:
        _join_group(0, world, port, run.device)
        # the control runs the program as it is; rank 0 halves its own set-up steps
        run.mode = None if mode == "control" else mode
        rec = base.Recorder(run, tr["warm_steps"])
        with Faults(run.mode):
            out = base.train(run, rec, world)
        dist.destroy_process_group()
    finally:
        for w in workers:
            try:
                w.wait(timeout=JOIN_S)
            except subprocess.TimeoutExpired:
                w.kill()
                w.wait()
    if any(w.returncode for w in workers) or not rec.stopped:
        raise RuntimeError(f"ranks ended with {[w.returncode for w in workers]}, "
                           f"rank 0 after {rec.k} steps")
    dev = run.device
    device = harness.card_facts(torch, 1) if dev.type == "cuda" else {}
    others = [torch.load(_rank_file(run.work_dir, r)) for r in range(1, world)]
    if device:
        device["count"] = world
        device["memory_peak_bytes"] = max([device["memory_peak_bytes"]]
                                          + [o["peak"] for o in others])
    trace = run.trace_facts()
    prog = {"losses": [float(x) for x in rec.losses], "grads": rec.snap["grads"],
            "init": rec.snap["init"], "after": rec.snap["after"]}
    del out
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    inputs = [tuple(torch.cat([mine[i]] + [o["inputs"][k][i] for o in others])
                    for i in range(3))
              for k, mine in enumerate(rec.inputs)]
    shape = base.shape_of(cfg, tr, world)
    ref = base.reference_readings(run, shape, inputs, world)
    run.mode = mode
    if mode == "control":
        prog = base.reference_readings(run, shape, inputs, world, quant="fp8")
    numbers = compare.train_numbers(prog, ref)
    clips = rec.window_steps * tr["batch"] * world
    lo, hi = run.lo, run.hi
    work = base.step_work(cfg, tr, world)
    facts = {"window_s": run.window_s, "steps": rec.window_steps, "clips": clips,
             "stall_s": run.spans.total_s("loader", lo, hi) + run.spans.total_s("save", lo, hi),
             "saves_ms": [1e3 * (b - a) for a, b in run.spans.inside("save", lo, hi)],
             "trace": trace, "flops_per_step": work["flops"], "chips": world}
    return {"attempted": clips, "failed": 0, "correct": True,
            "e2e": {"train_clips_per_s": clips / run.window_s, "setup_s": run.setup_s},
            "facts": facts, "numbers": numbers, "device": device,
            "readings": {"program": prog["losses"], "reference": ref["losses"]}}


def rank_main(argv=None) -> int:
    """A rank other than 0: joins the group, runs the training as rank 0
    does, checks its own ``sys.modules`` for JAX and the JAX package, and
    leaves its set-up steps' inputs and its peak memory in the run's
    directory."""
    import torch.distributed as dist

    from benchmark.run import ROOT, Run

    p = argparse.ArgumentParser()
    for flag in ("--cell", "--work-dir", "--mode", "--device"):
        p.add_argument(flag, required=True)
    for flag in ("--rank", "--world", "--port", "--seed"):
        p.add_argument(flag, type=int, required=True)
    a = p.parse_args(argv)
    harness.set_cache_dirs(ROOT)
    spec = harness.load_json(Path(a.cell))
    cell = harness.Cell(spec["workload"], spec["config"], spec["traffic"], [], [])
    device = torch.device("cpu") if a.device == "cpu" else torch.device("cuda", a.rank)
    run = Run(cell, a.seed, 0.0, False, device, time.perf_counter(), a.work_dir)
    run.mode = None if a.mode == "None" else a.mode
    _join_group(a.rank, a.world, a.port, device)
    rec = Follower(cell.traffic["warm_steps"])
    if run.mode == "fault:half":
        _half(rec)
    with Faults(run.mode):
        base.train(run, rec, a.world)
    dist.destroy_process_group()
    bad = harness.forbidden_modules()
    if bad:
        # rank 0 refuses the run on this rank's return code
        print(f"benchmark: rank {a.rank} loaded JAX or the JAX package: {bad}",
              file=sys.stderr, flush=True)
        return 3
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    torch.save({"inputs": rec.inputs, "peak": peak}, _rank_file(a.work_dir, a.rank))
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
