"""Export of the serving forward, on ``torch.export``.

Counterpart of ``timetuning_tpu/cli/export.py``: the dense-feature forward
(uint8 frames -> patch features, the eval preprocess folded in) saved as a
``.pt2`` program that holds the weights, loadable for inference without the
model code or the checkpoint importer:

    python -m timetuning_tpu_torch.cli.export --architecture dino-s16 \\
        --model_path TimeT.pth --batch_size 64 --out features.pt2

    # serving side
    from timetuning_tpu_torch.cli.export import load_exported
    fn = load_exported("features.pt2")
    feats = fn(frames_u8)        # [B, H, W, 3] uint8 -> [B, N, D]

The hand-written kernels are in the program as custom ops
(``timetuning_tpu_torch::*``, ops/kernel_lib.kernel_entry): the model calls
them while ``torch.export`` traces, so a bf16 program runs the preprocess
kernel and the block kernels on the card, and their plain versions on CPU
tensors. Loading a program needs that op registration (``load_exported``
imports it); JAX's StableHLO artifact carries its custom calls itself.

``--symbolic_batch`` exports one program for any batch. JAX traces the XLA
attention there, because its Pallas grids are batch-static; the custom ops
take any batch, so this program keeps the kernels.

``--moe_every_k K --moe_experts E`` export the MoE ViT sparse-upcycled from
the dense weights (JAX export.py:157-186: every K-th block's MLP becomes E
experts, each a copy of the dense MLP, the routers at their seeded init):
its MoE branches are plain ops in the graph, the preprocess and the
attention and dense MLP kernels stay custom ops. ``--device`` picks the
device (the card unless ``cpu``).

Multi-device programs (``--tensor_parallel``, ``--data_parallel``,
``--sequence_parallel``, ``--pipeline_parallel``, ``--expert_parallel``;
JAX export.py:137-320). JAX writes one SPMD artifact over an n-device mesh;
the port runs one process a device, so it writes one program a rank. Run
it under ``torchrun`` (or in ranks of a process group the caller
initialized) on at least ``data_parallel x (tp | sp | pp | ep)`` ranks:

    torchrun --nproc_per_node 2 -m timetuning_tpu_torch.cli.export \
        --architecture dino-s8 --input_resolution 448 --batch_size 4 \
        --sequence_parallel 2 --out features.json

Each rank on the mesh exports the forward of its static batch slice
``B / dp`` with its weights (its tp or ep slices, pp its own stage's
blocks, dp and sp the whole weights) and its collectives, which the program
holds as ``_c10d_functional`` ops on the mesh's process groups; rank 0
writes a manifest at ``--out`` (the mesh's kind, axis names and sizes, the
batch, ``n_micro``, the world size, each rank's program and group names),
and the programs go beside it (``<out>.rank<r>.pt2``). ``load_exported``
on each rank of a process group of the same size rebuilds the mesh, in the
exporter's order, and returns its rank's program: the rank's batch slice ->
its features. The tp program runs the plain attention (the block kernels
take whole weights, as ``parallel/tp.force_xla_attention``); ep, pp, sp
and dp keep the kernels as custom ops (JAX traces the XLA attention for
every multi-chip artifact because a Pallas call is opaque to GSPMD).
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os

import numpy as np
import torch
import torch.nn as nn

from timetuning_tpu_torch.cli.train import str2bool
from timetuning_tpu_torch.obs.profiling import annotate
from timetuning_tpu_torch.parallel import mesh as pm


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("timetuning_tpu_torch.export")
    p.add_argument("--architecture", type=str, default="dino-s16")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=64,
                   help="static serving batch (a mesh's: the global batch)")
    p.add_argument("--input_resolution", type=int, default=224)
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--out", type=str, required=True,
                   help="the program; with a mesh, its manifest (the ranks' "
                        "programs go beside it)")
    p.add_argument("--check", type=str2bool, default=True,
                   help="load the program and verify it against the live forward")
    p.add_argument("--symbolic_batch", type=str2bool, default=False,
                   help="export with a symbolic batch dimension: one program "
                        "serves any batch (the kernels included); "
                        "--batch_size (at least 2) becomes the example and "
                        "round-trip-check batch")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="one program a rank of a (data, model) mesh, the "
                        "weights Megatron-sharded over this many ranks")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="split the batch over this many data-axis ranks")
    p.add_argument("--sequence_parallel", type=int, default=1,
                   help="split the TOKEN axis over this many seq-axis ranks "
                        "(parallel/sp.py); exclusive with the other axes but "
                        "--data_parallel")
    p.add_argument("--pipeline_parallel", type=int, default=1,
                   help="split the block STACK into this many stages "
                        "(parallel/pp.py, a GPipe schedule)")
    p.add_argument("--pp_microbatches", type=int, default=0,
                   help="GPipe microbatches a data slice (0: the largest "
                        "divisor of the local batch <= the pipe degree)")
    p.add_argument("--expert_parallel", type=int, default=1,
                   help="shard the MoE experts over this many ranks "
                        "(parallel/ep.py; needs --moe_every_k/--moe_experts)")
    p.add_argument("--moe_every_k", type=int, default=0)
    p.add_argument("--moe_experts", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda, and an error where there "
                        "is no card; pass cpu to run on the host)")
    return p


def _check_flags(bb, batch_size, symbolic_batch, tensor_parallel,
                 data_parallel, sequence_parallel, pipeline_parallel,
                 expert_parallel, moe_every_k, moe_experts) -> None:
    """JAX's geometry checks (timetuning_tpu/cli/export.py:137-170, 211-221,
    236-266) with their ValueErrors."""
    if min(tensor_parallel, data_parallel, sequence_parallel,
           pipeline_parallel, expert_parallel) < 1:
        raise ValueError("tensor_parallel/data_parallel/sequence_parallel/"
                         "pipeline_parallel/expert_parallel must be >= 1")
    if sum(d > 1 for d in (tensor_parallel, sequence_parallel,
                           pipeline_parallel, expert_parallel)) > 1:
        raise ValueError(
            "--tensor_parallel, --sequence_parallel, --pipeline_parallel and "
            "--expert_parallel are mutually exclusive (weight- vs token- vs "
            "stage- vs expert-sharded artifacts)")
    if expert_parallel > 1 and not (moe_every_k and moe_experts):
        raise ValueError("--expert_parallel needs a MoE architecture: set "
                         "--moe_every_k and --moe_experts")
    vit = hasattr(getattr(bb.module, "config", None), "depth")
    if moe_every_k or moe_experts:
        if not vit:
            raise ValueError("--moe_every_k supports ViT backbones only")
        if not (moe_every_k and moe_experts):
            raise ValueError("set BOTH --moe_every_k and --moe_experts")
        from timetuning_tpu_torch.parallel.ep import validate_ep_geometry

        validate_ep_geometry(moe_experts, expert_parallel)
    n_mesh = (tensor_parallel * data_parallel * sequence_parallel
              * pipeline_parallel * expert_parallel)
    if n_mesh > 1:
        if symbolic_batch:
            raise ValueError("multi-chip artifacts are static-batch: the batch "
                             "shards over the data axis, which pins its size")
        if batch_size % data_parallel:
            raise ValueError(f"batch_size {batch_size} must divide over "
                             f"data_parallel={data_parallel}")
        for flag, n, what in (
                ("--sequence_parallel", sequence_parallel,
                 "the token-sharded block stack, parallel/sp.py"),
                ("--pipeline_parallel", pipeline_parallel,
                 "the stage-sharded block stack, parallel/pp.py"),
                ("--tensor_parallel", tensor_parallel,
                 "the Megatron sharding rules, parallel/tp.py")):
            if n > 1 and not vit:
                raise ValueError(f"{flag} supports ViT backbones only ({what})")


def upcycled_moe_backbone(bb, moe_every_k: int, moe_experts: int, seed: int = 0):
    """``bb`` with its ViT rebuilt as a MoE ViT, sparse-upcycled from its
    dense weights (parallel/ep.upcycle_dense_to_moe); the routers take a
    seeded init."""
    import dataclasses

    from timetuning_tpu_torch.models.vit import VisionTransformer
    from timetuning_tpu_torch.parallel.ep import upcycle_dense_to_moe

    dense = bb.module
    cfg = dataclasses.replace(dense.config, moe_every_k=moe_every_k,
                              n_experts=moe_experts)
    moe = VisionTransformer(cfg).init_weights(torch.Generator().manual_seed(seed))
    dev = next(dense.parameters()).device
    sd = {k: v.cpu() for k, v in dense.state_dict().items()}
    moe.load_state_dict(upcycle_dense_to_moe(sd, moe.state_dict(), cfg))
    return dataclasses.replace(bb, module=moe.to(dev).eval())


class FeatureForward(nn.Module):
    """uint8 frames [B, H, W, 3] -> the backbone's dense features: the eval
    preprocess in the compute dtype (JAX's ``forward``, export.py:293-298:
    the kernel's uint8 -> bf16 in bf16), the backbone (or ``tokens``, a
    forward over the backbone's parameters: the sp and pp forwards), the CLS
    token dropped where the backbone has one to drop."""

    def __init__(self, backbone, input_resolution: int, dtype: torch.dtype,
                 tokens=None):
        super().__init__()
        self.backbone = backbone.module
        self.input_resolution = input_resolution
        self.dtype = dtype
        self.drop_cls = backbone.drop_cls
        self.tokens = tokens

    def forward(self, frames_u8):
        from timetuning_tpu_torch.data.transforms import eval_preprocess_batch

        x = eval_preprocess_batch(frames_u8, out_size=self.input_resolution,
                                  compute_dtype=self.dtype)
        tokens = self.backbone(x)["tokens"] if self.tokens is None else self.tokens(x)
        return tokens[:, 1:] if self.drop_cls else tokens


@dataclasses.dataclass
class ExportMesh:
    """The mesh of a multi-device export and what the manifest records of
    it: ``kind`` (tp, dp, ep, sp or pp: the inner axis's, dp alone a
    ``(data, model)`` mesh of inner size 1), the global ``batch``, the
    pipeline's ``n_micro``, the process group's ``world_size``."""

    mesh: object
    kind: str
    batch: int
    n_micro: int | None
    world_size: int

    @property
    def coords(self):
        return self.mesh.coords

    def local_slice(self, x):
        """This rank's data slice of a global batch."""
        b = self.batch // self.mesh.n_outer
        d = self.mesh.outer_index
        return x[d * b:(d + 1) * b]


def _make_mesh(kind: str, dp: int, n: int):
    from timetuning_tpu_torch.parallel import ep, pp, sp, tp

    return {"tp": tp.make_dp_tp_mesh, "dp": tp.make_dp_tp_mesh, "ep": ep.make_dp_ep_mesh,
            "sp": sp.make_dp_sp_mesh, "pp": pp.make_dp_pp_mesh}[kind](dp, n)


def _mesh_device(device: str | None) -> torch.device:
    """The device of this rank of a multi-device export: with the caller's
    process group as it is, else with torchrun's
    (``parallel/mesh.init_from_env``: cuda:LOCAL_RANK unless ``cpu``)."""
    from timetuning_tpu_torch.runtime import resolve_device

    if not pm.is_initialized() and "WORLD_SIZE" in os.environ:
        return pm.init_from_env(device)
    return resolve_device(device)


def export_features(architecture: str, model_path: str | None,
                    batch_size: int, input_resolution: int,
                    compute_dtype: str = "bfloat16",
                    symbolic_batch: bool = False,
                    tensor_parallel: int = 1, data_parallel: int = 1,
                    sequence_parallel: int = 1, pipeline_parallel: int = 1,
                    pp_microbatches: int = 0, expert_parallel: int = 1,
                    moe_every_k: int = 0, moe_experts: int = 0,
                    device: str | None = None):
    """Build and export the uint8 -> features forward. Returns (the saved
    program's bytes, the live forward, the global input shape, the mesh).
    Without ``model_path`` the weights are the registry's seeded init (seed
    0); with ``moe_every_k`` / ``moe_experts`` the backbone is upcycled to a
    MoE ViT (``upcycled_moe_backbone``).

    One device: the mesh is None. A mesh (any of the parallel flags > 1) is
    a COLLECTIVE over the process group (module docstring): the mesh is an
    ``ExportMesh``, and the program and the live forward are this rank's,
    over its data slice of the batch (``ExportMesh.local_slice``); a rank
    past the mesh gets None for both."""
    from timetuning_tpu_torch.models.registry import get_backbone
    from timetuning_tpu_torch.runtime import resolve_device

    kinds = (("tp", tensor_parallel), ("sp", sequence_parallel),
             ("pp", pipeline_parallel), ("ep", expert_parallel))
    n_inner = tensor_parallel * sequence_parallel * pipeline_parallel * expert_parallel
    n_mesh = data_parallel * n_inner
    dev = _mesh_device(device) if n_mesh > 1 else resolve_device(device)
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    bb = get_backbone(architecture, model_path, dtype=dtype, device=dev)
    _check_flags(bb, batch_size, symbolic_batch, tensor_parallel,
                 data_parallel, sequence_parallel, pipeline_parallel,
                 expert_parallel, moe_every_k, moe_experts)
    if moe_every_k:
        bb = upcycled_moe_backbone(bb, moe_every_k, moe_experts)
    if symbolic_batch and batch_size < 2:
        raise ValueError("--symbolic_batch exports from an example batch of at "
                         f"least 2 (a batch of 1 specialises), got {batch_size}")
    shape = (batch_size, input_resolution, input_resolution, 3)
    em, tokens = None, None
    if n_mesh > 1:
        world = pm.data_world_size() if pm.is_initialized() else 1
        if world < n_mesh:
            raise ValueError(f"mesh export needs {n_mesh} devices, found {world}")
        kind = next((k for k, n in kinds if n > 1), "dp")
        mesh = _make_mesh(kind, data_parallel, n_inner)
        n_micro = None
        if kind == "pp":
            from timetuning_tpu_torch.parallel.pp import _auto_n_micro, validate_pp_geometry

            n_micro = pp_microbatches or _auto_n_micro(batch_size // data_parallel,
                                                       pipeline_parallel)
            validate_pp_geometry(bb.module.config, pipeline_parallel, batch_size,
                                 data_parallel, n_micro)
        em = ExportMesh(mesh, kind, batch_size, n_micro, world)
        if mesh.coords is None:
            return None, None, shape, em
        tokens = _shard_for_mesh(bb.module, em)
    live = FeatureForward(bb, input_resolution, dtype, tokens).eval()
    local = shape if em is None else (batch_size // data_parallel, *shape[1:])
    example = torch.zeros(local, dtype=torch.uint8, device=dev)
    dynamic = {"frames_u8": {0: torch.export.Dim("b")}} if symbolic_batch else None
    # opt_einsum would plan the resize's three-operand einsum from the
    # example's sizes, which pins a symbolic batch: trace the einsum as
    # written (left to right)
    opt_einsum = torch.backends.opt_einsum.enabled
    torch.backends.opt_einsum.enabled = False
    try:
        with torch.no_grad():
            program = torch.export.export(live, (example,), dynamic_shapes=dynamic,
                                          strict=False)
    finally:
        torch.backends.opt_einsum.enabled = opt_einsum
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue(), live, shape, em


def _shard_for_mesh(vit, em: ExportMesh):
    """Give this rank its share of ``vit`` for ``em``'s kind (in place):
    tp and ep their slices, pp its stage; returns the sp or pp forward that
    replaces the backbone's own, or None."""
    from timetuning_tpu_torch.parallel import ep, pp, sp, tp

    mesh = em.mesh
    if em.kind == "tp":
        tp.validate_tp_geometry(vit.config, mesh.n_inner)
        tp.shard_params(mesh, vit)
    elif em.kind == "ep":
        ep.shard_experts(mesh, vit)
    elif em.kind == "sp":
        return sp.sp_forward_fn(vit, mesh)
    elif em.kind == "pp":
        return pp.pp_forward_fn(vit, mesh, em.n_micro)
    return None


def program_path(out: str, rank: int) -> str:
    """Where rank ``rank``'s program of the manifest ``out`` goes."""
    return f"{out}.rank{rank}.pt2"


def _group_names(mesh) -> dict:
    """This rank's process groups of ``mesh`` by name: "inner" or "outer"."""
    return {g.group_name: axis for axis, g in (("inner", mesh.inner), ("outer", mesh.outer))
            if g is not None}


def save_exported(out: str, blob: bytes | None, em: ExportMesh | None) -> list:
    """Write the program at ``out``; with a mesh (a collective), each mesh
    rank's program at ``program_path(out, rank)`` and rank 0's manifest at
    ``out``. Returns the programs' sizes in bytes, a rank each (None past
    the mesh)."""
    if em is None:
        with open(out, "wb") as f:
            f.write(blob)
        return [len(blob)]
    import torch.distributed as dist

    rank = dist.get_rank()
    mine = None
    if blob is not None:
        with open(program_path(out, rank), "wb") as f:
            f.write(blob)
        mine = {"program": os.path.basename(program_path(out, rank)), "bytes": len(blob),
                "coords": list(em.coords), "groups": _group_names(em.mesh)}
    ranks = [None] * em.world_size
    dist.all_gather_object(ranks, mine)
    if rank == 0:
        mesh = em.mesh
        manifest = {"format": "timetuning_tpu_torch mesh export", "kind": em.kind,
                    "axis_names": list(mesh.axis_names),
                    "axis_sizes": [mesh.n_outer, mesh.n_inner],
                    "batch": em.batch, "n_micro": em.n_micro,
                    "world_size": em.world_size, "ranks": ranks}
        with open(out, "w") as f:
            json.dump(manifest, f, indent=1)
    dist.barrier()
    return [None if r is None else r["bytes"] for r in ranks]


def _manifest(path) -> dict | None:
    """The manifest at ``path``, or None where it holds a program."""
    if not isinstance(path, (str, os.PathLike)):
        return None
    with open(path, "rb") as f:
        if f.read(1) != b"{":
            return None
    with open(path) as f:
        return json.load(f)


def _rename_groups(gm, names: dict) -> None:
    """Point the functional collectives of the loaded program ``gm`` at this
    process's groups: ``names`` maps the exporter's group names to ours."""
    for node in gm.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("_c10d_functional"):
            node.args = tuple(names.get(a, a) if isinstance(a, str) else a
                              for a in node.args)
    gm.recompile()


def load_exported(path, graphed: bool = True):
    """Serving-side loader: a saved program (path or file object) ->
    callable(frames_u8). Registers the kernels' custom ops (ops/kernel_lib),
    which the program calls by name; imports no model code.

    A one-device program is replayed as one CUDA graph a batch shape on the
    card (runtime.CapturedCall around ``torch.export.load(path).module()``;
    the serving counterpart of JAX's compiled StableHLO): the program's
    ``_assert_tensor_metadata`` guards are host checks, so they run at the
    capture and drop out of the replay; nothing is stripped from the saved
    program. Each call returns a tensor of its own (copied out of the
    graph's memory, which the next call of any batch shape overwrites), as
    the eager module does; ``graphed=False`` returns the module itself.

    A mesh's manifest (``save_exported``) loads on each rank of an
    initialized process group of the exporter's size: the mesh is rebuilt
    (a collective, in the exporter's order), and the call takes the rank's
    data slice of the batch (rows ``[d * b, (d + 1) * b)``, ``d`` the first
    of the rank's ``coords`` in the manifest, ``b`` the batch over the data
    axis's size) and returns its features; None past the mesh."""
    from timetuning_tpu_torch.ops import kernel_lib

    kernel_lib.register_ops()
    manifest = _manifest(path)
    if manifest is None:
        from timetuning_tpu_torch.runtime import CapturedCall

        module = torch.export.load(path).module()
        if not graphed:
            return module
        program = CapturedCall(module)

        def serve(frames_u8):
            with annotate("serve.call"):
                return program(frames_u8).clone()

        return serve
    world = pm.data_world_size() if pm.is_initialized() else 1
    if world != manifest["world_size"]:
        raise ValueError(f"{path} holds a {manifest['kind']} mesh of "
                         f"{manifest['world_size']} ranks; the process group has {world}")
    mesh = pm.make_2d_mesh(*manifest["axis_sizes"], tuple(manifest["axis_names"]))
    mine = manifest["ranks"][pm.data_rank()]
    if mine is None:
        return None
    fn = torch.export.load(os.path.join(os.path.dirname(os.path.abspath(path)),
                                        mine["program"])).module()
    ours = {axis: name for name, axis in _group_names(mesh).items()}
    _rename_groups(fn, {old: ours[axis] for old, axis in mine["groups"].items()})
    return fn


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    owned = not pm.is_initialized()
    try:
        return _main(args)
    finally:
        if owned and pm.is_initialized():
            import torch.distributed as dist

            dist.destroy_process_group()


def _main(args) -> int:
    blob, live, shape, em = export_features(
        args.architecture, args.model_path, args.batch_size,
        args.input_resolution, args.compute_dtype,
        symbolic_batch=args.symbolic_batch,
        tensor_parallel=args.tensor_parallel,
        data_parallel=args.data_parallel,
        sequence_parallel=args.sequence_parallel,
        pipeline_parallel=args.pipeline_parallel,
        pp_microbatches=args.pp_microbatches,
        expert_parallel=args.expert_parallel,
        moe_every_k=args.moe_every_k,
        moe_experts=args.moe_experts,
        device=args.device,
    )
    sizes = save_exported(args.out, blob, em)
    lead = em is None or pm.data_rank() == 0
    if em is None:
        note = ""
    elif args.sequence_parallel > 1:
        note = f", {args.data_parallel}x{args.sequence_parallel} seq mesh"
    elif args.pipeline_parallel > 1:
        note = f", {args.data_parallel}x{args.pipeline_parallel} pipe mesh"
    elif args.expert_parallel > 1:
        note = (f", {args.data_parallel}x{args.expert_parallel} expert mesh "
                f"({args.moe_experts} experts upcycled every {args.moe_every_k} blocks)")
    else:
        note = f", {args.data_parallel}x{args.tensor_parallel} mesh"
    if lead:
        mb = ", ".join(f"{n / 1e6:.1f}" for n in sizes if n is not None)
        print(f"exported {args.architecture} forward ({shape} uint8 -> features) "
              f"to {args.out} ({mb} MB{' a rank' if em else ''}{note})")
    if not args.check:
        return 0
    fn = load_exported(args.out)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, shape, np.uint8))
    err = 0.0
    if live is not None:
        dev = next(live.parameters()).device
        x = (x if em is None else em.local_slice(x)).to(dev)
        with torch.no_grad():
            got, want = fn(x), live(x)
        err = float((got.float() - want.float()).abs().max())
    if em is not None:
        import torch.distributed as dist

        errs = [None] * em.world_size
        dist.all_gather_object(errs, err)
        err = max(errs)
    if lead:
        print(f"round-trip check: max|Δ| = {err:.2e}")
    if err > 1e-3:
        if lead:
            print("FAIL: round-trip mismatch")
        return 1
    if args.symbolic_batch:
        alt = args.batch_size + 1
        x2 = torch.from_numpy(np.random.default_rng(1).integers(
            0, 256, (alt,) + shape[1:], np.uint8)).to(dev)
        with torch.no_grad():
            got2 = fn(x2)
        if got2.shape[0] != alt:
            print(f"FAIL: batch {alt} gave features {tuple(got2.shape)}")
            return 1
        print(f"symbolic-batch check: batch {alt} ok "
              f"(features {tuple(got2.shape)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
