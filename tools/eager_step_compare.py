#!/usr/bin/env python3
"""The eager train step of several trees of the port, in turns on one card.

    python tools/eager_step_compare.py OLD NEW NEW OLD [--out FILE]

Each argument is the root of a tree of the port (an unpacked ``git
archive`` of a commit, or ``.``); each runs in a process of its own with
that tree's ``timetuning_tpu_torch`` (its kernels built into that tree),
in the order given, so parent, change, change, parent compares two commits
within one call. The model, data and timing are this file's tree's
``chip_smoke.py`` helpers (``build_train``: the flagship at full width,
bf16, default configuration, no queue; ``synthetic_clip_bank``: the
training loop's 8 synthetic 480 x 854 clips at 256, 4 frames), the same for every
tree. For each tree, at 32 and 128 clips:

* ``full``: ``core/train.make_full_step`` (``graphed=False`` where the
  tree has the option): augmentation + step;
* ``augment``: ``draw_augment_params`` + ``apply_augment`` alone;
* ``step``: ``core/timet.make_train_step``'s step on augmented clips;
* at 32 clips, ``full queue``: ``full`` with a queue of 960 rows (ready from
  the third step on, as the ``graphs`` phase of ``chip_smoke.py`` runs it);

each as ms a call (CUDA events over 6 calls after 3, no sync between them),
host ms a call (no sync) and the device's busy ms and idle share
(``chip_smoke.trace``). Where the tree splits its step into ``plan`` /
``device_step`` / ``commit``, also the host ms of ``plan`` with the table's
copy, of the grad path's parameter aliasing (the leaves and
``functional_call``'s reparametrisation, entered and left), and the
augmentation's fixed-size selection (``chip_smoke.selection_extra``). Then
``core/train.run_training`` eager at 32 clips, 2 epochs of 4 steps
(``chip_smoke.driver_config``; clips/s over the window and inside an epoch,
the first two steps left out), and the 2-rank data-parallel step (gloo on
the one card, 32 clips a rank, 6 steps each timed between
synchronisations, the first left out). Prints a
line a measurement and a JSON object a tree; ``--out`` writes them all.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DP_WORLD, DP_STEPS = 2, 6


def _smoke():
    """This file's tree's ``chip_smoke`` (its helpers import the package
    lazily, so they run on the tree first on ``sys.path``)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def _setup(tree: str):
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return _smoke()


def _timed(cs, fn, label: str) -> dict:
    return {"ms": cs.cuda_ms(fn, warmup=3, reps=6, queued=False),
            "host_ms": cs.host_ms(fn, calls=6), **cs.trace(fn, label, reps=3, top=3)}


def _host_each(fn, calls: int = 50) -> float:
    """Host ms a call of ``fn``, the device synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return out


def single(tree: str) -> dict:
    import numpy as np
    import torch

    cs = _setup(tree)
    from timetuning_tpu_torch.core.train import make_full_step
    from timetuning_tpu_torch.data import transforms as tf
    from timetuning_tpu_torch.ops import kernel_lib

    dev = torch.device("cuda", 0)
    kernel_lib.build()
    kernel_lib.library()
    label = Path(tree).resolve().name
    graphed_kw = ({"graphed": False}
                  if "graphed" in inspect.signature(make_full_step).parameters else {})
    aug = tf.AugmentConfig()
    bank, gray = cs.synthetic_clip_bank(cs.DRIVER_BANK, 4, 256)
    out = {"tree": label, "nvidia_smi": cs.nvidia_smi()}
    for B in (32, 128):
        idx = np.arange(B) % cs.DRIVER_BANK
        frames = torch.from_numpy(bank[idx]).to(dev)
        sizes = torch.tensor([cs.DRIVER_NATIVE] * B, device=dev)
        gmeans = torch.from_numpy(gray[idx]).to(dev)
        model, cfg, mask, state, step = cs.build_train(dev, torch.bfloat16)
        full = make_full_step(model, cfg, state.opt, aug, trainable_mask=mask,
                              opt_over_trainable=True, **graphed_kw)
        gen = torch.Generator().manual_seed(B)
        clips, _ = tf.apply_augment(frames, tf.draw_augment_params(gen, B, 4, aug), aug,
                                    sizes, gmeans)
        res = {
            "full": _timed(cs, lambda: full(state, frames, sizes, gmeans, gen),
                           f"{label} full B={B}"),
            "augment": _timed(cs, lambda: tf.apply_augment(
                frames, tf.draw_augment_params(gen, B, 4, aug), aug, sizes, gmeans),
                f"{label} augment B={B}"),
            "step": _timed(cs, lambda: step(state, clips, gen), f"{label} step B={B}"),
        }
        if B == 32:
            qmodel, qcfg, qmask, qstate, _ = cs.build_train(dev, torch.bfloat16,
                                                            use_queue=True, queue_size=960)
            qfull = make_full_step(qmodel, qcfg, qstate.opt, aug, trainable_mask=qmask,
                                   opt_over_trainable=True, **graphed_kw)
            res["full queue"] = _timed(cs, lambda: qfull(qstate, frames, sizes, gmeans, gen),
                                       f"{label} full queue B={B}")
            del qmodel, qstate, qfull
        if hasattr(step, "plan"):
            from timetuning_tpu_torch.data.loader import host_batch_to_device
            from torch.nn.utils.stateless import _reparametrize_module

            def plan():
                p = step.plan(state, B, gen)
                host_batch_to_device(np.asarray(p.scalars, np.float32), dev)

            named = dict(model.named_parameters())
            train = {n for n, m in mask.items() if m}

            def alias():
                leaves = {n: p.detach().requires_grad_(n in train) for n, p in named.items()}
                with _reparametrize_module(model, leaves, tie_weights=True):
                    pass

            res["plan_host_ms"] = _host_each(plan)
            res["alias_host_ms"] = _host_each(alias)
            res["selection"] = cs.selection_extra(dev, B)
        for part in ("full", "full queue", "augment", "step"):
            if part not in res:
                continue
            r = res[part]
            print(f"{label} {part} B={B}: {r['ms']:.3f} ms a call, host {r['host_ms']:.3f} "
                  f"ms, device busy {r['busy_ms']:.3f} ms, idle {100 * r['idle']:.2f} %",
                  flush=True)
        if "plan_host_ms" in res:
            sel = res["selection"]
            print(f"{label} B={B}: plan + table copy host {res['plan_host_ms']:.4f} ms, "
                  f"grad-path aliasing host {res['alias_host_ms']:.4f} ms; gray mean + hue "
                  f"of every clip {sel['every']:.4f} ms device against the drawing clips' "
                  f"{sel['subset']:.4f}", flush=True)
        out[B] = res
        del model, state, step, full, clips
        torch.cuda.empty_cache()
    out["run_training"] = train_loop(cs, graphed_kw)
    return out


def train_loop(cs, graphed_kw: dict) -> dict:
    """``run_training`` at 32 clips, 2 epochs of 4 steps, eager."""
    import functools
    import tempfile

    import numpy as np
    import torch

    from timetuning_tpu_torch.core import train as ttrain

    dev = torch.device("cuda", 0)
    make = ttrain.make_full_step
    ttrain.make_full_step = functools.partial(make, **graphed_kw)
    try:
        with tempfile.TemporaryDirectory() as log_dir, cs.step_times() as rec:
            out = ttrain.run_training(cs.driver_config(dev, log_dir, 32))
    finally:
        ttrain.make_full_step = make
    if out["global_step"] != 8 or not np.isfinite(out["final_loss"]):
        raise AssertionError(f"run_training: {out['global_step']} steps, loss {out['final_loss']}")
    r = cs.driver_rates(rec, 32, per_epoch=4, skip=2)
    print(f"run_training B=32 eager: clips/s over the window {r['window']:.1f}, inside an epoch "
          f"{r['in_epoch']:.1f}; median ms a step {r['median']:.3f} (steps {r['gaps']})",
          flush=True)
    return r


def dp_rank(rank: int, tree: str, port: int, result: str) -> None:
    """One rank of the data-parallel step: gloo on the one card."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    cs = _setup(tree)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=DP_WORLD, timeout=datetime.timedelta(seconds=300))
    try:
        clip = cs.synthetic_train_clips(cs.TRAIN_B, dev, seed=100 + rank)
        _, _, _, state, step = cs.build_train(dev, torch.bfloat16, axis_name="data",
                                              world_size=DP_WORLD)
        ms = []
        for _ in range(DP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = step(state, clip)
            float(m["loss"])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        if rank == 0:
            Path(result).write_text(json.dumps({"ms": ms[1:], "median": float(np.median(ms[1:]))}))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dp(tree: str) -> dict:
    import socket
    import tempfile

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as d:
        result = os.path.join(d, "dp.json")
        mp.start_processes(dp_rank, args=(tree, port, result), nprocs=DP_WORLD,
                           start_method="spawn")
        out = json.loads(Path(result).read_text())
    print(f"{Path(tree).resolve().name} dp step, {DP_WORLD} gloo ranks, {32} clips a rank: "
          f"median {out['median']:.3f} ms (steps {[round(m, 3) for m in out['ms']]})",
          flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--out")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        out = single(args.worker)
        out["dp"] = dp(args.worker)
        print("RESULT " + json.dumps(out), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("eager_step_compare: needs a CUDA card")
    results = []
    for tree in args.trees:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        proc = subprocess.run([sys.executable, __file__, "--worker", tree, tree], env=env,
                              capture_output=True, text=True, timeout=900)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode:
            raise SystemExit(f"eager_step_compare: {tree} exited {proc.returncode}")
        results.append(json.loads(next(line for line in proc.stdout.splitlines()
                                       if line.startswith("RESULT "))[7:]))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
