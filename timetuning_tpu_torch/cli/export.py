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
take any batch, so this program keeps the kernels. The flags of JAX's
multi-device and mixture-of-experts artifacts are checked as JAX checks
them and then raise: mixture-of-experts blocks are ROADMAP.md queue 1 item
11b, the multi-device artifacts item 11c. ``--device`` picks the device (the
card unless ``cpu``).
"""

from __future__ import annotations

import argparse
import io

import numpy as np
import torch
import torch.nn as nn

from timetuning_tpu_torch.cli.train import str2bool

_UNPORTED_MOE = ("is not ported yet: mixture-of-experts blocks are ROADMAP.md "
                 "queue 1 item 11b")
_UNPORTED_MESH = ("is not ported yet: the artifacts of the tp, sp, pp, ep and "
                  "data axes are ROADMAP.md queue 1 item 11c")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("timetuning_tpu_torch.export")
    p.add_argument("--architecture", type=str, default="dino-s16")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=64,
                   help="static serving batch")
    p.add_argument("--input_resolution", type=int, default=224)
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--check", type=str2bool, default=True,
                   help="load the program and verify it against the live forward")
    p.add_argument("--symbolic_batch", type=str2bool, default=False,
                   help="export with a symbolic batch dimension: one program "
                        "serves any batch (the kernels included); "
                        "--batch_size (at least 2) becomes the example and "
                        "round-trip-check batch")
    p.add_argument("--tensor_parallel", type=int, default=1)
    p.add_argument("--data_parallel", type=int, default=1)
    p.add_argument("--sequence_parallel", type=int, default=1)
    p.add_argument("--pipeline_parallel", type=int, default=1)
    p.add_argument("--pp_microbatches", type=int, default=0)
    p.add_argument("--expert_parallel", type=int, default=1)
    p.add_argument("--moe_every_k", type=int, default=0)
    p.add_argument("--moe_experts", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda, and an error where there "
                        "is no card; pass cpu to run on the host)")
    return p


def _check_unported(bb, batch_size, symbolic_batch, tensor_parallel,
                    data_parallel, sequence_parallel, pipeline_parallel,
                    expert_parallel, moe_every_k, moe_experts) -> None:
    """JAX's geometry checks (timetuning_tpu/cli/export.py:137-170, 211-221)
    with their ValueErrors, then NotImplementedError for what passes them."""
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
    if moe_every_k or moe_experts:
        if not hasattr(getattr(bb.module, "config", None), "depth"):
            raise ValueError("--moe_every_k supports ViT backbones only")
        if not (moe_every_k and moe_experts):
            raise ValueError("set BOTH --moe_every_k and --moe_experts")
        raise NotImplementedError(f"--moe_every_k/--moe_experts {_UNPORTED_MOE}")
    n_mesh = (tensor_parallel * data_parallel * sequence_parallel
              * pipeline_parallel * expert_parallel)
    if n_mesh > 1:
        if symbolic_batch:
            raise ValueError("multi-chip artifacts are static-batch: the batch "
                             "shards over the data axis, which pins its size")
        if batch_size % data_parallel:
            raise ValueError(f"batch_size {batch_size} must divide over "
                             f"data_parallel={data_parallel}")
        raise NotImplementedError(f"a multi-device artifact {_UNPORTED_MESH}")


class FeatureForward(nn.Module):
    """uint8 frames [B, H, W, 3] -> the backbone's dense features: the eval
    preprocess in the compute dtype (JAX's ``forward``, export.py:293-298:
    the kernel's uint8 -> bf16 in bf16), the backbone, the CLS token
    dropped where the backbone has one to drop."""

    def __init__(self, backbone, input_resolution: int, dtype: torch.dtype):
        super().__init__()
        self.backbone = backbone.module
        self.input_resolution = input_resolution
        self.dtype = dtype
        self.drop_cls = backbone.drop_cls

    def forward(self, frames_u8):
        from timetuning_tpu_torch.data.transforms import eval_preprocess_batch

        x = eval_preprocess_batch(frames_u8, out_size=self.input_resolution,
                                  compute_dtype=self.dtype)
        tokens = self.backbone(x)["tokens"]
        return tokens[:, 1:] if self.drop_cls else tokens


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
    program's bytes, the live forward, the example input shape, None); the
    last is JAX's mesh, which a one-device program does not have. Without
    ``model_path`` the weights are the registry's seeded init (seed 0)."""
    from timetuning_tpu_torch.models.registry import get_backbone
    from timetuning_tpu_torch.runtime import resolve_device

    dev = resolve_device(device)
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    bb = get_backbone(architecture, model_path, dtype=dtype, device=dev)
    _check_unported(bb, batch_size, symbolic_batch, tensor_parallel,
                    data_parallel, sequence_parallel, pipeline_parallel,
                    expert_parallel, moe_every_k, moe_experts)
    if symbolic_batch and batch_size < 2:
        raise ValueError("--symbolic_batch exports from an example batch of at "
                         f"least 2 (a batch of 1 specialises), got {batch_size}")
    live = FeatureForward(bb, input_resolution, dtype).eval()
    shape = (batch_size, input_resolution, input_resolution, 3)
    example = torch.zeros(shape, dtype=torch.uint8, device=dev)
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
    return buf.getvalue(), live, shape, None


def load_exported(path):
    """Serving-side loader: a saved program (path or file object) ->
    callable(frames_u8). Registers the kernels' custom ops (ops/kernel_lib),
    which the program calls by name; imports no model code."""
    from timetuning_tpu_torch.ops import kernel_lib

    kernel_lib.register_ops()
    return torch.export.load(path).module()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    blob, live, shape, _ = export_features(
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
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"exported {args.architecture} forward ({shape} uint8 -> features) "
          f"to {args.out} ({len(blob) / 1e6:.1f} MB)")
    if args.check:
        fn = load_exported(args.out)
        dev = next(live.parameters()).device
        x = torch.from_numpy(
            np.random.default_rng(0).integers(0, 256, shape, np.uint8)).to(dev)
        with torch.no_grad():
            got, want = fn(x), live(x)
        err = float((got.float() - want.float()).abs().max())
        print(f"round-trip check: max|Δ| = {err:.2e}")
        if err > 1e-3:
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
