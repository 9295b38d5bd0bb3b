"""Ranks of the port's data-parallel tests: a launcher and the worker.

``spawn(job, workdir, world)`` starts ``world`` processes of this script,
each a rank of a gloo group on ``tcp://localhost:<free port>`` (60 s
timeout), hands them ``job`` (a list of cases, saved with ``torch.save``) and
returns each rank's results. A rank that fails, or a group that outlives
``timeout`` seconds, fails the call: every process is killed first, so a
hang fails a test instead of stalling the suite.

The worker imports torch and the port only (no jax): it also records the
modules of JAX or of the JAX package that got loaded, which must be none.

    python tests/torch_dp_worker.py JOB RANK WORLD PORT OUT_DIR [DEVICE]
"""

from __future__ import annotations

import contextlib
import datetime
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the tests' model: ViT patch 8, width 32, depth 2, 32 px, head (48, 24),
# 8 prototypes, block 1 + head + prototypes trainable (tests/test_zero1.py)
VIT = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, img_size=32)
HEAD, K = (48, 24), 8
UNFREEZE = ("blocks.1",)
SCHED = dict(num_epochs=1, steps_per_epoch=10)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def single_rank_group():
    """A gloo group of this process alone, destroyed on exit."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def spawn(job: list, workdir: str, world: int = 2, timeout: float = 240.0,
          device: str = "cpu") -> list[dict]:
    """Run ``job`` on ``world`` ranks; returns the ranks' result dicts."""
    os.makedirs(workdir, exist_ok=True)
    job_path = os.path.join(workdir, "job.pt")
    torch.save(job, job_path)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job_path, str(r), str(world),
         str(port), workdir, device],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.time() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [o.decode(errors="replace")[-4000:] for o in outs]
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n{logs[r]}")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------- the model


def torch_model(state_dict=None):
    from timetuning_tpu_torch.core import timet as tt
    from timetuning_tpu_torch.models.extractor import FeatureExtractor
    from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer

    vit = VisionTransformer(ViTConfig(dtype=torch.float32, **VIT))
    model = tt.TimeT(FeatureExtractor(vit, VIT["embed_dim"], HEAD), K)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def build_step(case: dict, group_world: int, rank: int):
    """(state, step_fn, plan) of a step case on this rank."""
    from timetuning_tpu_torch.core import timet as tt
    from timetuning_tpu_torch.core.optimizer import swav_optimizer, swav_optimizer_zero1

    model = torch_model(case["state_dict"])
    dp = group_world > 0
    cfg = tt.TimeTConfig(n_prototypes=K, spatial_resolution=4, **SCHED,
                         axis_name="data" if dp else None,
                         world_size=max(group_world, 1), **case["cfg"])
    over = case.get("opt_over_trainable", True)
    kw = dict(lr=1e-3, unfreeze_layers=UNFREEZE, **SCHED)
    plan = None
    if case.get("zero1"):
        opt, mask, plan = swav_optimizer_zero1(model, world_size=group_world,
                                               rank=rank, **kw)
    else:
        opt, mask = swav_optimizer(model, opt_over_trainable=over, **kw)
    state = tt.init_state(model, cfg, opt, trainable_mask=mask if over else None)
    step = tt.make_train_step(model, cfg, opt, trainable_mask=mask,
                              opt_over_trainable=over)
    return state, step, plan


def run_steps(case: dict, rank: int, world: int) -> dict:
    """``case["clips"]`` [steps, global B, F, H, W, 3]: this rank's slice of
    each, stepped; the queue's draws are handed over (``case["draws"]``)."""
    from timetuning_tpu_torch.core import checkpoint, timet as tt

    draws = iter(case.get("draws") or [])
    real = tt.queue_store_indices
    tt.queue_store_indices = (lambda n, k, g: torch.as_tensor(next(draws), dtype=torch.int64)
                              if case.get("draws") else real(n, k, g))
    try:
        state, step, plan = build_step(case, world, rank)
        losses = []
        for clip in case["clips"]:
            n = clip.shape[0] // world
            local = torch.from_numpy(np.ascontiguousarray(clip[rank * n:(rank + 1) * n]))
            state, m = step(state, local, None)
            losses.append(float(m["loss"]))
    finally:
        tt.queue_store_indices = real
    out = {"losses": losses,
           "params": {k: v.clone() for k, v in state.model.state_dict().items()},
           "teacher": {k: v.clone() for k, v in (state.teacher or {}).items()},
           "queue": None if state.queue is None else state.queue.clone(),
           "queue_fill": state.queue_fill,
           "replicated": {k: v.clone() for k, v in tt.replicated_tensors(state).items()},
           "partition": tt.state_partition_specs(state)}
    if plan is not None:
        out["zero1"] = {"padded": plan.padded, "chunk": plan.chunk,
                        "mu": state.opt.mu.clone(), "nu": state.opt.nu.clone()}
    if case.get("save_dir"):
        from timetuning_tpu_torch.parallel.mesh import data_group

        checkpoint.save_checkpoint(state, case["save_dir"], 1,
                                   meta={"world_size": world, "opt_layout": "zero1"
                                         if plan is not None else "trainable-subtree"},
                                   group=data_group("data"))
    return out


def run_sinkhorn(case: dict, rank: int, world: int) -> dict:
    """The group Sinkhorn (plain: the matvec form; on the card also kernel
    11's cross-rank form) on this rank's columns of the global scores."""
    from timetuning_tpu_torch.ops import sinkhorn as skm
    from timetuning_tpu_torch.ops import sinkhorn_cuda
    from timetuning_tpu_torch.parallel.mesh import data_group

    group = data_group("data")
    out = {}
    for key, (scores, valid) in case["inputs"].items():
        n = scores.shape[0] // world
        dev = torch.device(case.get("device", "cpu"))
        s = torch.from_numpy(scores[rank * n:(rank + 1) * n]).to(dev)
        v = None if valid is None else torch.from_numpy(valid[rank * n:(rank + 1) * n]).to(dev)
        q = torch.exp(s / 0.05).t()
        out[key] = skm.sinkhorn(q, n_iters=10, group=group, world_size=world,
                                valid=v).cpu()
        if dev.type == "cuda":
            from timetuning_tpu_torch.ops import kernel_lib

            kernel_lib.reset_launch_counts()
            out[key + "/kernel"] = sinkhorn_cuda.sinkhorn_assignment_dp_cuda(
                s, 0.05, 10, group=group, world_size=world, valid=v).cpu()
            out[key + "/route"] = skm.sinkhorn_assignment(
                s, 0.05, 10, group=group, world_size=world, valid=v).cpu()
            torch.cuda.synchronize()
            out[key + "/launches"] = kernel_lib.launch_counts()
    return out


def run_contrastive(case: dict, rank: int, world: int) -> dict:
    from timetuning_tpu_torch.models.moco import contrastive_loss

    q, k = case["q"], case["k"]
    n = q.shape[0] // world
    qt = torch.from_numpy(q[rank * n:(rank + 1) * n]).requires_grad_(True)
    kt = torch.from_numpy(k[rank * n:(rank + 1) * n])
    loss = contrastive_loss(qt, kt, 0.2, axis_name="data")
    loss.backward()
    return {"loss": float(loss), "grad_finite": bool(torch.isfinite(qt.grad).all())}


def run_loader(case: dict, rank: int, world: int) -> dict:
    from timetuning_tpu_torch.data.datasets import SamplingMode
    from timetuning_tpu_torch.data.loader import host_batch_to_device, make_loader
    from timetuning_tpu_torch.parallel.mesh import shard_batch

    loader = make_loader("davis", num_clip_frames=3, batch_size=1, regular_step=1,
                         sampling_mode=SamplingMode.UNIFORM, shuffle=True,
                         num_workers=0, root=case["root"], seed=1,
                         world_size=world, rank=rank, load_annotations=False)
    batches = [host_batch_to_device(b[0], "cpu") for b in loader]
    glob = np.arange(world * 6).reshape(world * 3, 2)
    return {"len": len(loader), "batches": [b.clone() for b in batches],
            "shard": shard_batch(glob, "cpu")}


def run_driver(case: dict, rank: int, world: int) -> dict:
    """``run_training`` at this world size; ``sigterm_at``: rank 1 signals
    itself SIGTERM at that many steps, and the ranks must stop together."""
    from timetuning_tpu_torch.core import timet as tt, train as ttrain

    cfg = ttrain.TrainingConfig(**case["cfg"])
    at = case.get("sigterm_at")
    if at is not None:
        real = ttrain.make_full_step

        def counting(*a, **kw):
            full = real(*a, **kw)
            calls = [0]

            def step(*sa, **skw):
                calls[0] += 1
                if rank == 1 and calls[0] == at:
                    os.kill(os.getpid(), signal.SIGTERM)
                return full(*sa, **skw)
            return step
        ttrain.make_full_step = counting
    r = ttrain.run_training(cfg)
    return {k: r[k] for k in ("run_dir", "final_loss", "global_step", "preempted")} | {
        "step": r["state"].step,
        "replicated": {k: v.clone() for k, v in tt.replicated_tensors(r["state"]).items()}}


CASES = {"step": run_steps, "sinkhorn": run_sinkhorn, "contrastive": run_contrastive,
         "loader": run_loader, "driver": run_driver}


def main(argv) -> int:
    job_path, rank, world, port, out_dir = argv[:5]
    device = argv[5] if len(argv) > 5 else "cpu"
    rank, world = int(rank), int(world)
    import torch.distributed as dist

    torch.set_num_threads(1)
    if device != "cpu":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    job = torch.load(job_path, weights_only=False)
    results = {}
    for case in job:
        results[case["name"]] = CASES[case["kind"]](case, rank, world)
    results["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "timetuning_tpu"))
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
