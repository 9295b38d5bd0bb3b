"""Ranks of the port's data-, tensor-, expert-, sequence- and
pipeline-parallel tests and of its multi-device export: a launcher and the
worker.

``spawn(job, workdir, world)`` starts ``world`` processes of this script,
each a rank of a gloo group on ``tcp://localhost:<free port>`` (60 s
timeout), hands them ``job`` (a list of cases, saved with ``torch.save``) and
returns each rank's results. A rank that fails, or a group that outlives
``timeout`` seconds, fails the call: every process is killed first, so a
hang fails a test instead of stalling the suite.

The worker imports torch and the port only (no jax): it also records the
modules of JAX or of the JAX package that got loaded, which must be none.
The ``card_*`` cases run the flagship at full width on the rank's card
(``tests/test_torch_card_paths.py``).

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


def torch_model(state_dict=None, vit_kw=None):
    from timetuning_tpu_torch.core import timet as tt
    from timetuning_tpu_torch.models.extractor import FeatureExtractor
    from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer

    vit_kw = {"dtype": torch.float32, **(VIT if vit_kw is None else vit_kw)}
    vit = VisionTransformer(ViTConfig(**vit_kw))
    model = tt.TimeT(FeatureExtractor(vit, vit_kw["embed_dim"], HEAD), K)
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


def run_mesh_step(case: dict, rank: int, world: int) -> dict:
    """A TP or EP case on a 2-D mesh (``case["mesh"]``: "tp" or "ep", of
    ``case["dp"]`` x ``case["n"]`` ranks; the ranks past it return {}): the
    whole weights sharded, the backbone's forward on this rank's data slice
    of ``case["x"]`` (tokens and last-block probabilities), then the steps
    on its slices of ``case["clips"]`` (global batches, the queue's draws
    handed over to the mesh's origin, reversed to the other ranks). Returns
    the losses and auxiliaries, the gathered student and teacher, the
    queue, this rank's slice shapes, the replicated and the sharded tensors; with
    ``load_dir`` the one-process checkpoint there is loaded first and saved
    again to ``save_dir``."""
    from timetuning_tpu_torch.core import checkpoint, timet as tt
    from timetuning_tpu_torch.core.optimizer import swav_optimizer
    from timetuning_tpu_torch.parallel import ep, tp
    from timetuning_tpu_torch.parallel.mesh import data_group

    if case["mesh"] == "tp":
        mesh = tp.make_dp_tp_mesh(case["dp"], case["n"])
    else:
        mesh = ep.make_dp_ep_mesh(case["dp"], case["n"])
    if mesh.coords is None:
        return {}
    model = torch_model(case["state_dict"], case["vit"])
    if case["mesh"] == "tp":
        sharding = tp.shard_params(mesh, model)
    else:
        sharding = ep.shard_experts(mesh, model)
    d, n_data = mesh.outer_index, mesh.n_outer
    out = {"coords": mesh.coords}
    x = case["x"]
    b = x.shape[0] // n_data
    with torch.no_grad():
        fwd = model.feature_extractor.backbone(torch.from_numpy(x[d * b:(d + 1) * b]),
                                               want_attention=True)
    out["tokens"], out["attention"] = fwd["tokens"], fwd["attention"]
    cfg = tt.TimeTConfig(n_prototypes=K, spatial_resolution=4, **SCHED, **case["cfg"])
    opt, mask = swav_optimizer(model, lr=1e-3, unfreeze_layers=case["unfreeze"],
                               opt_over_trainable=True, **SCHED)
    state = tt.init_state(model, cfg, opt, trainable_mask=mask, mesh=mesh)
    make = tp.make_tp_train_step if case["mesh"] == "tp" else ep.make_ep_train_step
    step, _ = make(model, cfg, opt, mesh, state, trainable_mask=mask,
                   opt_over_trainable=True)
    if case.get("load_dir"):
        checkpoint.load_checkpoint(case["load_dir"], state)
        checkpoint.save_checkpoint(state, case["save_dir"], 1, group=data_group("data"))
        out["loaded"] = {k: v.clone() for k, v in tt.state_tensors(state).items()}
        return out
    draws = iter(case["draws"])
    # a rank off the mesh's origin draws other rows: the step keeps the
    # origin's choice on every rank
    off = mesh.coords != (0, 0)
    real = tt.queue_store_indices
    tt.queue_store_indices = lambda n, k, g: torch.as_tensor(
        np.array(next(draws)[::-1] if off else next(draws)), dtype=torch.int64)
    try:
        losses, aux = [], []
        for clip in case["clips"]:
            b = clip.shape[0] // n_data
            _, m = step(state, torch.from_numpy(np.ascontiguousarray(clip[d * b:(d + 1) * b])),
                        None)
            losses.append(float(m["loss"]))
            aux.append(float(m["moe_aux"]) if "moe_aux" in m else None)
    finally:
        tt.queue_store_indices = real
    out.update(
        losses=losses, aux=aux, params=tp.gather_global_params(model),
        teacher={k: v.cpu() for k, v in sharding.gather_state_dict(state.teacher).items()},
        queue=None if state.queue is None else state.queue.clone(),
        queue_fill=state.queue_fill,
        shapes={k: tuple(v.shape) for k, v in model.named_parameters()
                if sharding.spec_of(k) is not None},
        replicated={k: v.clone() for k, v in tt.replicated_tensors(state).items()},
        sharded={k: v.clone() for k, v in tt.sharded_tensors(state).items()},
        shardings={k: v for k, v in (
            tp.timet_state_shardings(state, mesh) if case["mesh"] == "tp" else
            ep.ep_state_shardings(state, mesh, model.feature_extractor.backbone.config.n_experts)
        ).items() if v != "replicated"},
        partition=tt.state_partition_specs(state))
    if case.get("save_dir"):
        checkpoint.save_checkpoint(state, case["save_dir"], 1, group=data_group("data"))
    return out


def run_gather(case: dict, rank: int, world: int) -> dict:
    """``gather_along`` over the inner axis of a ``case["dp"]`` x
    ``case["n"]`` mesh: each rank's [2, 1, 3] block of its global rank's
    value side by side, and the gradient of a weighted sum of the whole."""
    from timetuning_tpu_torch.parallel.mesh import gather_along, make_2d_mesh

    mesh = make_2d_mesh(case["dp"], case["n"], ("data", "model"))
    if mesh.coords is None:
        return {}
    x = torch.full((2, 1, 3), float(rank), requires_grad=True)
    y = gather_along(x, 1, mesh.inner)
    w = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape)
    (y * w).sum().backward()
    return {"coords": mesh.coords, "grid": mesh.grid, "y": y.detach(), "w": w,
            "grad": x.grad}


def run_cli(case: dict, rank: int, world: int) -> dict:
    """``cli/train.main`` with ``--multihost true`` once for each argv of
    ``case["argvs"]``, torchrun's environment set (a port each: every run
    initializes and takes down its own group); the lines it prints."""
    import io
    import torch.distributed as dist

    from timetuning_tpu_torch.cli import train as tcli

    printed = []
    for argv, port in zip(case["argvs"], case["ports"]):
        if dist.is_initialized():
            dist.destroy_process_group()
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert tcli.main(argv + ["--multihost", "true"]) == 0
        printed.append(buf.getvalue())
    return {"printed": printed}


def run_seq_pipe(case: dict, rank: int, world: int) -> dict:
    """An sp or pp forward (``case["mesh"]``) on a ``case["dp"]`` x
    ``case["n"]`` mesh (the ranks past it return {}) of the bare ViT
    ``case["vit"]`` (ViTConfig keywords) with ``case["state_dict"]``, on
    this rank's data slice of ``case["x"]``: its tokens, the names it holds,
    and with ``case["grad"]`` the gradients of ``sum(tokens ** 2)``."""
    from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer
    from timetuning_tpu_torch.parallel import pp, sp

    if case["mesh"] == "sp":
        mesh = sp.make_dp_sp_mesh(case["dp"], case["n"])
    else:
        mesh = pp.make_dp_pp_mesh(case["dp"], case["n"])
    if mesh.coords is None:
        return {}
    vit = VisionTransformer(ViTConfig(**case["vit"]))
    vit.load_state_dict(case["state_dict"])
    if case["mesh"] == "sp":
        fwd = sp.sp_forward_fn(vit, mesh)
    else:
        fwd = pp.pp_forward_fn(vit, mesh, case.get("n_micro"))
    b = case["x"].shape[0] // case["dp"]
    d = mesh.outer_index
    x = torch.from_numpy(case["x"][d * b:(d + 1) * b]).to(vit.config.dtype)
    out = {"coords": mesh.coords}
    with torch.set_grad_enabled(bool(case.get("grad"))):
        tokens = fwd(x)
    if case.get("grad"):
        (tokens.float() ** 2).sum().backward()
        out["grads"] = {k: p.grad.clone() for k, p in vit.named_parameters()
                        if p.grad is not None}
    out["tokens"] = tokens.detach()
    out["held"] = sorted(vit.state_dict())
    return out


class _Forward(torch.nn.Module):
    """A forward function over ``vit``'s parameters, as a module to export."""

    def __init__(self, vit, fwd):
        super().__init__()
        self.vit, self.fwd = vit, fwd

    def forward(self, x):
        return self.fwd(x)


def run_sp_export(case: dict, rank: int, world: int) -> dict:
    """A seeded bf16 ``auto`` ViT of ``case["vit"]`` on a 1 x ``case["n"]``
    seq mesh: its sp forward exported with ``torch.export`` (the kernels'
    custom ops it calls, its functional all-reduces), the saved program
    loaded and called, beside the live sp forward and the one-process
    forward on the same 2 images."""
    import io

    from timetuning_tpu_torch.cli.export import load_exported
    from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer
    from timetuning_tpu_torch.parallel import sp

    mesh = sp.make_dp_sp_mesh(1, case["n"])
    if mesh.coords is None:
        return {}
    vit = VisionTransformer(ViTConfig(dtype=torch.bfloat16, **case["vit"])).init_weights(
        torch.Generator().manual_seed(0)).eval()
    size = case["vit"]["img_size"]
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, size, size, 3)).astype(
        np.float32)).to(torch.bfloat16)
    fwd = sp.sp_forward_fn(vit, mesh)
    with torch.no_grad():
        program = torch.export.export(_Forward(vit, fwd), (x,), strict=False)
        live, one = fwd(x), vit(x)["tokens"]
    nodes = [n for n in program.graph.nodes if n.op == "call_function"]
    buf = io.BytesIO()
    torch.export.save(program, buf)
    with torch.no_grad():
        got = load_exported(io.BytesIO(buf.getvalue()))(x)
    return {"ops": {n.target.name().split("::")[1].split(".")[0] for n in nodes
                    if "timetuning_tpu_torch" in str(n.target)},
            "collectives": sum("_c10d_functional.all_reduce" in str(n.target) for n in nodes),
            "program": got, "live": live, "one": one}


def run_all_gather(case: dict, rank: int, world: int) -> dict:
    """``all_gather_along`` over the inner axis of a ``case["dp"]`` x
    ``case["n"]`` mesh: each rank's [2, 1, 3] block of its global rank's
    value side by side, and the gradient of a weighted sum of the whole
    whose weights differ by rank."""
    from timetuning_tpu_torch.parallel.mesh import all_gather_along, make_2d_mesh

    mesh = make_2d_mesh(case["dp"], case["n"], ("data", "seq"))
    if mesh.coords is None:
        return {}
    x = torch.full((2, 1, 3), float(rank), requires_grad=True)
    y = all_gather_along(x, 1, mesh.inner)
    w = (torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) + 1) * (rank + 1)
    (y * w).sum().backward()
    return {"coords": mesh.coords, "grid": mesh.grid, "y": y.detach(), "w": w,
            "grad": x.grad}


def run_export_mesh(case: dict, rank: int, world: int) -> dict:
    """``cli/export``'s multi-device programs: for each entry of
    ``case["programs"]`` (name -> export_features keywords) the programs
    and the manifest written to ``case["dir"]/<name>.json``
    (``export_features`` + ``save_exported``, or ``main`` for the names in
    ``case["main"]``: its printed lines), and this rank's live mesh forward
    on its data slice of ``case["frames"]`` (on ``case["device"]``).
    ``case["moe_state"]``: the upcycled MoE ViT's whole state dict, loaded
    over the port's upcycle (the routers' init)."""
    import io

    from timetuning_tpu_torch.cli import export as texport

    dev = case.get("device", "cpu")
    real = texport.upcycled_moe_backbone
    if case.get("moe_state") is not None:
        def upcycle(bb, k, e, seed=0):
            bb = real(bb, k, e, seed)
            bb.module.load_state_dict(case["moe_state"])
            return bb
        texport.upcycled_moe_backbone = upcycle
    out = {}
    try:
        for name, kw in case["programs"].items():
            path = os.path.join(case["dir"], name.replace(" ", "_") + ".json")
            if name in case.get("main", ()):
                argv = [f"--{k}={v}" for k, v in kw.items()] + ["--out", path]
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = texport.main(argv)
                out[name] = {"rc": rc, "printed": buf.getvalue()}
                continue
            blob, live, _, em = texport.export_features(**kw)
            texport.save_exported(path, blob, em)
            if live is None:
                out[name] = {}
                continue
            with torch.no_grad():
                got = live(torch.from_numpy(em.local_slice(case["frames"])).to(dev))
            out[name] = {"coords": em.coords, "live": got.cpu()}
    finally:
        texport.upcycled_moe_backbone = real
    return out


def run_load_mesh(case: dict, rank: int, world: int) -> dict:
    """Each program of ``case["paths"]`` (name -> manifest) loaded with
    ``load_exported`` and called on this rank's data slice of
    ``case["frames"]`` (on ``case["device"]``): its output and the kernel
    launches of the call."""
    import json

    from timetuning_tpu_torch.cli import export as texport
    from timetuning_tpu_torch.ops import kernel_lib

    dev = case.get("device", "cpu")
    out = {}
    for name, path in case["paths"].items():
        fn = texport.load_exported(path)
        if fn is None:
            out[name] = {}
            continue
        manifest = json.load(open(path))
        d = manifest["ranks"][rank]["coords"][0]
        b = manifest["batch"] // manifest["axis_sizes"][0]
        x = torch.from_numpy(case["frames"][d * b:(d + 1) * b]).to(dev)
        with torch.no_grad():
            kernel_lib.reset_launch_counts()
            got = fn(x)
        out[name] = {"coords": tuple(manifest["ranks"][rank]["coords"]),
                     "program": got.cpu(), "launches": kernel_lib.launch_counts()}
    return out


# --------------------------------------------------------------- on the card

S16 = 224
MOE = dict(moe_every_k=2, n_experts=8, moe_capacity_factor=1.25)


def train_clips(n: int, dev, seed: int = 0) -> torch.Tensor:
    """[n, 4, 224, 224, 3] f32 clips as the augmentation hands them to the
    step: three coloured boxes moving over a colour gradient
    (``benchmark/generate.clips``, from ``seed``), normalised."""
    from benchmark import generate
    from timetuning_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

    frames, _ = generate.clips(seed, n, 4, S16, S16, (3, 3), False, "gradient", dev)
    x = torch.from_numpy(frames).to(dev).float() / 255
    return (x - x.new_tensor(IMAGENET_MEAN)) / x.new_tensor(IMAGENET_STD)


def moe_vit(dtype, seed: int = 0):
    """(dense, MoE) DINO ViT-S/16 at 224 from ``seed``, on the host: the MoE
    ViT (``MOE``: every 2nd block 8 experts) sparse-upcycled from the dense
    weights, its routers a seeded init (``cli/export``'s construction)."""
    import dataclasses

    from timetuning_tpu_torch.models.vit import VisionTransformer, vit_small
    from timetuning_tpu_torch.parallel.ep import upcycle_dense_to_moe

    cfg = vit_small(16, img_size=S16, dtype=dtype)
    dense = VisionTransformer(cfg).init_weights(torch.Generator().manual_seed(seed))
    mcfg = dataclasses.replace(cfg, **MOE)
    moe = VisionTransformer(mcfg).init_weights(torch.Generator().manual_seed(seed + 1))
    moe.load_state_dict(upcycle_dense_to_moe(dense.state_dict(), moe.state_dict(), mcfg))
    return dense, moe


def flagship(dev, dtype, attn_impl: str = "auto", remat: bool = False, moe: bool = False,
             zero1: bool = False, shard=None, mesh=None, sched=None, full_step=None,
             **cfg_kw):
    """The reference's flagship at full width (time_tuning.py:573-577): DINO
    ViT-S/16 at 224, head [1024, 1024, 512, 256], 200 prototypes, seeded;
    blocks 10 and 11, the head and the prototypes trainable over 10 frozen
    trunk blocks, AdamW over the trainable subtree. ``moe``: the ViT of
    ``moe_vit``; ``zero1``: the optimizer state split over the data axis;
    ``shard(model)`` keeps a rank's slices before the optimizer is built,
    ``mesh`` is the step's 2-D mesh; ``sched``: the schedule's
    ``num_epochs`` and ``steps_per_epoch`` (default 1 and 100);
    ``full_step``: ``core/train.make_full_step``'s keywords, for its step
    (augmentation included) in place of ``make_train_step``'s; ``cfg_kw``:
    more ``TimeTConfig`` fields. Returns (model, cfg, mask, state, step)."""
    import dataclasses

    from timetuning_tpu_torch.core import timet as tt
    from timetuning_tpu_torch.core.optimizer import swav_optimizer, swav_optimizer_zero1
    from timetuning_tpu_torch.models.extractor import FeatureExtractor
    from timetuning_tpu_torch.models.vit import VisionTransformer, vit_small
    from timetuning_tpu_torch.parallel.mesh import data_rank

    vcfg = vit_small(16, img_size=S16, dtype=dtype, attn_impl=attn_impl, remat=remat)
    vit = VisionTransformer(dataclasses.replace(vcfg, **MOE) if moe else vcfg)
    model = tt.TimeT(FeatureExtractor(vit, 384, (1024, 1024, 512, 256)), 200)
    model.init_weights(torch.Generator().manual_seed(0))
    if moe:
        vit.load_state_dict(moe_vit(dtype)[1].state_dict())
    model.to(dev)
    if shard is not None:
        shard(model)
    sched = sched or dict(num_epochs=1, steps_per_epoch=100)
    cfg = tt.TimeTConfig(n_prototypes=200, use_teacher=True, frozen_trunk_blocks=10,
                         n_last_frames=7, size_mask_neighborhood=6, topk=5,
                         spatial_resolution=S16 // 16, **sched, **cfg_kw)
    if zero1:
        opt, mask, _ = swav_optimizer_zero1(model, world_size=cfg.world_size,
                                            rank=data_rank(), lr=1e-4, **sched)
    else:
        opt, mask = swav_optimizer(model, opt_over_trainable=True, lr=1e-4, **sched)
    state = tt.init_state(model, cfg, opt, trainable_mask=mask, mesh=mesh)
    if full_step is not None:
        from timetuning_tpu_torch.core.train import make_full_step
        from timetuning_tpu_torch.data.transforms import AugmentConfig

        step = make_full_step(model, cfg, opt, AugmentConfig(), trainable_mask=mask,
                              opt_over_trainable=True, **full_step)
    else:
        step = tt.make_train_step(model, cfg, opt, trainable_mask=mask,
                                  opt_over_trainable=True, mesh=mesh)
    return model, cfg, mask, state, step


def replica_mismatches(state, group=None) -> int:
    """Tensors of the replicated state that differ from rank 0's, bit for
    bit."""
    import torch.distributed as dist

    from timetuning_tpu_torch.core import timet as tt

    bad = 0
    for t in tt.replicated_tensors(state).values():
        ref = t.detach().clone()
        dist.broadcast(ref, 0, group=group)
        bad += int(not torch.equal(ref, t))
    return bad


def card_steps(state, step, clip, n_steps: int) -> dict:
    """``n_steps`` steps on ``clip``: the losses, the MoE auxiliaries (None
    without) and the kernel launches of the steps."""
    from timetuning_tpu_torch.ops import kernel_lib

    torch.cuda.synchronize()
    kernel_lib.reset_launch_counts()
    losses, aux = [], []
    for _ in range(n_steps):
        _, m = step(state, clip)
        losses.append(float(m["loss"]))
        aux.append(float(m["moe_aux"]) if "moe_aux" in m else None)
    torch.cuda.synchronize()
    return {"losses": losses, "aux": aux, "counts": kernel_lib.launch_counts()}


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


def bank_dataset(name: str = "card_bank", frames: int = 4, decode: int = 256) -> str:
    """Register ``name`` with ``data/loader``: as many videos as its
    ``data_root`` says, each a clip of a bank of 8 seeded ones
    (``benchmark/generate``, the train cell's boxes over a gradient) in the
    item layout of the benchmark's ``BankDataset``; returns ``name``."""
    from benchmark import generate
    from benchmark.drivers.timet_train import BankDataset
    from timetuning_tpu_torch.data.loader import register_dataset

    bank, _ = generate.clips(5, 8, frames, decode, decode, (3, 3), False, "gradient", "cpu")
    gray = generate.pil_gray_means(bank)
    register_dataset(name)(
        lambda _n, root, **_kw: BankDataset(bank, gray, int(root), (480, 854)))
    return name


def driver_config(dev, log_dir: str, batch: int, world: int = 1, **kw):
    """``run_training``'s configuration of the flagship (the train cell's
    model: dino-s16 at 224, head [1024, 1024, 512, 256], 200 prototypes,
    bf16, 4-frame clips from a 256 buffer) over ``bank_dataset``: ``batch``
    clips a rank, 2 epochs of 4 steps, 2 loader workers; ``kw`` overrides."""
    from timetuning_tpu_torch.core.train import TrainingConfig

    steps = kw.get("max_steps_per_epoch", 4)
    base = dict(architecture="dino-s16", dataset=bank_dataset(),
                data_root=str(steps * batch * world), log_dir=log_dir, batch_size=batch,
                num_frames=4, decode_size=256, num_workers=2, num_clusters=200,
                input_resolution=224, compute_dtype="bfloat16", num_epochs=2,
                max_steps_per_epoch=4, use_tensorboard=False, device=str(dev))
    return TrainingConfig(**(base | kw))


def run_card_driver(case, rank, world):
    """``run_training`` of the flagship on the data axis at ``case["clips"]``
    clips a rank: 2 epochs of 4 steps, then a resume for a third (the
    launches, steps and run dir of each, the replicas after); then
    ``cli/train --multihost true --tensor_parallel 2`` for an epoch of 2
    steps and a resumed second (each run takes down its group, so they come
    last; gloo, as two ranks share the card)."""
    import io

    import torch.distributed as dist

    from timetuning_tpu_torch.cli import train as tcli
    from timetuning_tpu_torch.core import train as ttrain
    from timetuning_tpu_torch.ops import kernel_lib

    dev, B, logs = case["device"], case["clips"], case["log_dir"]
    out = {}
    for key, kw in (("first", {}), ("resumed", dict(num_epochs=3, load_checkpoint=True))):
        torch.cuda.synchronize()
        kernel_lib.reset_launch_counts()
        r = ttrain.run_training(driver_config(dev, os.path.join(logs, "dp"), B, world, **kw))
        torch.cuda.synchronize()
        out[key] = {"step": r["global_step"], "run_dir": r["run_dir"],
                    "loss": r["final_loss"], "counts": kernel_lib.launch_counts()}
    out["mismatches"] = replica_mismatches(r["state"])
    del r
    torch.cuda.empty_cache()
    argv = ["--multihost", "true", "--tensor_parallel", str(world), "--device", dev,
            "--architecture", "dino-s16", "--dataset", bank_dataset(),
            "--data_root", str(2 * B), "--batch_size", str(B // world), "--num_frames", "4",
            "--num_workers", "2", "--log_dir", os.path.join(logs, "cli"),
            "--use_queue", "true", "--queue_size", "4096"]
    out["cli"] = []
    for extra, port in zip((["--num_epochs", "1"],
                            ["--num_epochs", "2", "--load_checkpoint", "true"]), case["ports"]):
        if dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()
        # cli/train keeps a group it finds: gloo, not its NCCL
        os.environ.update(RANK=str(rank), LOCAL_RANK="0", WORLD_SIZE=str(world),
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert tcli.main(argv + extra) == 0
        out["cli"].append(buf.getvalue())
    return out


def run_card_dp(case, rank, world):
    """The flagship's bf16 steps on the data axis at ``case["clips"]`` clips
    a rank, default then ZeRO-1 (``card_steps``, the matvec form's calls,
    ``replica_mismatches``); kernel 11's cross-rank form on the default
    run's last scores against the plain group form, and on rank 0 the
    one-launch kernel 11 on the gathered scores against the gathered
    result; then 2 f32 steps at 4 clips a rank (rank 0: the trainable
    parameters after them)."""
    from timetuning_tpu_torch.core import timet as tt
    from timetuning_tpu_torch.ops import sinkhorn as skm
    from timetuning_tpu_torch.ops import sinkhorn_cuda as sk
    from timetuning_tpu_torch.parallel.mesh import all_gather_rows, data_group

    dev = torch.device(case["device"])
    group = data_group("data")
    clip = train_clips(case["clips"], dev, seed=100 + rank)
    seen, calls = {}, [0]
    assign, plain = tt.sinkhorn_assignment, skm.sinkhorn

    def recording(scores, *a, **kw):
        seen["scores"] = scores
        return assign(scores, *a, **kw)

    def counting(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    out = {}
    for name, zero1 in (("default", False), ("zero1", True)):
        _, _, _, state, step = flagship(dev, torch.bfloat16, zero1=zero1, axis_name="data",
                                        world_size=world)
        calls[0] = 0
        tt.sinkhorn_assignment, skm.sinkhorn = recording, counting
        try:
            out[name] = card_steps(state, step, clip, 3)
        finally:
            tt.sinkhorn_assignment, skm.sinkhorn = assign, plain
        out[name].update(plain_calls=calls[0], mismatches=replica_mismatches(state, group))
        del state, step
    scores = seen["scores"]
    kern = sk.sinkhorn_assignment_dp_cuda(scores, 0.05, 10, group=group, world_size=world)
    want = skm.sinkhorn(torch.exp(scores / 0.05).t(), 10, group=group, world_size=world)
    out["sinkhorn"] = {"err": float((kern - want).abs().max())}
    s_all, k_all = all_gather_rows(scores, group), all_gather_rows(kern, group)
    if rank == 0:
        one = sk.sinkhorn_assignment_cuda(s_all, 0.05, 10)
        out["sinkhorn"]["err_global"] = float((one - k_all).abs().max())
    model, _, mask, state, step = flagship(dev, torch.float32, axis_name="data",
                                           world_size=world)
    clip = train_clips(4, dev, seed=200 + rank)
    out["f32"] = {"losses": [float(step(state, clip)[1]["loss"]) for _ in range(2)]}
    if rank == 0:
        out["f32"]["params"] = {n: p.detach().cpu().clone()
                                for n, p in model.named_parameters() if mask[n]}
    return out


def run_card_mesh(case, rank, world):
    """The flagship on a dp 1 x ``world`` mesh, ``case["mesh"]`` "ep" (the
    MoE ViT, the experts split) or "tp" (the dense one, qkv, fc1, proj and
    fc2 split; plain attention): the bare ViT's tokens on 4 frames, 3 bf16
    steps at ``case["clips"]`` clips (``card_steps``, the sharded leaves'
    shapes, ``replica_mismatches``), then 2 f32 steps at 4 clips."""
    from timetuning_tpu_torch.core import timet as tt
    from timetuning_tpu_torch.models.vit import VisionTransformer, vit_small
    from timetuning_tpu_torch.parallel import ep, tp

    dev = torch.device(case["device"])
    if case["mesh"] == "ep":
        mesh = ep.make_dp_ep_mesh(1, world)
        vit = moe_vit(torch.bfloat16)[1].to(dev).eval()
        ep.shard_experts(mesh, vit)

        def shard(m):
            ep.shard_experts(mesh, m)

        kw = dict(moe=True, moe_aux_weight=0.01)
    else:
        mesh = tp.make_dp_tp_mesh(1, world)
        vit = VisionTransformer(vit_small(16, img_size=S16, dtype=torch.bfloat16)).init_weights(
            torch.Generator().manual_seed(0)).to(dev).eval()
        tp.shard_params(mesh, vit)

        def shard(m):
            tp.force_xla_attention(m)
            tp.shard_params(mesh, m)

        kw = {}
    with torch.no_grad():
        out = {"tokens": vit(train_clips(1, dev, seed=7)[0])["tokens"].float().cpu()}
    _, _, _, state, step = flagship(dev, torch.bfloat16, shard=shard, mesh=mesh, **kw)
    out.update(card_steps(state, step, train_clips(case["clips"], dev, seed=300), 3))
    out["shapes"] = {n: tuple(v.shape) for n, v in tt.sharded_tensors(state).items()
                     if n.startswith("params.")}
    out["mismatches"] = replica_mismatches(state)
    del state, step
    model, _, _, state, step = flagship(dev, torch.float32, shard=shard, mesh=mesh, **kw)
    clip = train_clips(4, dev, seed=301)
    out["f32"] = [float(step(state, clip)[1]["loss"]) for _ in range(2)]
    if case["mesh"] == "tp":
        from timetuning_tpu_torch.core.checkpoint import save_checkpoint
        from timetuning_tpu_torch.parallel.mesh import data_group

        os.makedirs(case["ckpt"], exist_ok=True)
        save_checkpoint(state, case["ckpt"], 1, group=data_group("data"))
        out["gathered"] = tp.gather_global_params(model)
    return out


def run_card_seq_pipe(case, rank, world):
    """The registry's bf16 and f32 ViTs on a dp 1 x ``world`` mesh:
    ``dino-s8`` on ``case["x448"]`` through the sp feature function, then
    ``dino-s16`` on ``case["x224"]`` through the pp one at each n_micro of
    ``case["n_micro"]``: the tokens and the kernel launches of each forward,
    and for pp the parameter bytes the rank holds beside the whole model's."""
    from timetuning_tpu_torch.models.registry import get_backbone
    from timetuning_tpu_torch.ops import kernel_lib
    from timetuning_tpu_torch.parallel import pp, sp

    dev = torch.device(case["device"])

    def forward(fn, x):
        with torch.no_grad():
            torch.cuda.synchronize()
            kernel_lib.reset_launch_counts()
            tokens = fn(torch.from_numpy(x).to(dev))
            torch.cuda.synchronize()
        return {"tokens": tokens.float().cpu(), "counts": kernel_lib.launch_counts()}

    def param_bytes(module):
        return sum(p.numel() * p.element_size() for p in module.parameters())

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        vit = get_backbone("dino-s8", dtype=dtype, device=dev).module.eval()
        out["sp", dtype] = forward(sp.make_sp_feature_fn(vit, sp.make_dp_sp_mesh(1, world)),
                                   case["x448"])
        vit = get_backbone("dino-s16", dtype=dtype, device=dev).module.eval()
        whole = param_bytes(vit)
        mesh = pp.make_dp_pp_mesh(1, world)
        for nm in case["n_micro"]:
            out["pp", dtype, nm] = forward(pp.make_pp_feature_fn(vit, mesh, nm), case["x224"])
            out["pp", dtype, nm].update(param_bytes=param_bytes(vit), whole_bytes=whole)
    return out


CASES = {"step": run_steps, "sinkhorn": run_sinkhorn, "contrastive": run_contrastive,
         "loader": run_loader, "driver": run_driver, "mesh_step": run_mesh_step,
         "gather": run_gather, "cli": run_cli, "seq_pipe": run_seq_pipe,
         "sp_export": run_sp_export, "all_gather": run_all_gather, "export_mesh": run_export_mesh,
         "load_mesh": run_load_mesh, "card_dp": run_card_dp, "card_mesh": run_card_mesh,
         "card_seq_pipe": run_card_seq_pipe, "card_driver": run_card_driver}


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
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
