"""Evaluation CLI, the ``python evaluation.py`` equivalent, on PyTorch.

Counterpart of ``timetuning_tpu/cli/evaluate.py`` (reference
evaluation.py:490-563 flag surface): the same flags and defaults, plus
``--device`` (the card unless ``--device cpu``; an error where there is no
card). Clusters the dense features of a video or image dataset under one of
the three protocols and prints ``score: <mIoU>``.

    python -m timetuning_tpu_torch.cli.evaluate --data_root DAVIS \\
        --evaluation_protocol dataset-wise --compute_dtype bfloat16
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from timetuning_tpu_torch.cli.train import str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("timetuning_tpu_torch.evaluate")
    p.add_argument("--architecture", type=str, default="dino-s16")
    p.add_argument("--model_path", type=str, default=None,
                   help="backbone or TimeT checkpoint (.pth)")
    p.add_argument("--dataset", type=str, default="davis_val")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_frames", type=int, default=4)
    p.add_argument("--input_resolution", type=int, default=224)
    p.add_argument("--eval_resolution", type=int, default=112)
    p.add_argument("--num_clusters", type=int, default=10)
    p.add_argument("--evaluation_protocol", type=str, default="frame-wise",
                   choices=["frame-wise", "sample-wise", "dataset-wise"])
    p.add_argument("--clustering_algorithm", type=str, default="k-means",
                   choices=["k-means", "prototypes"])
    p.add_argument("--many_to_one", type=str2bool, default=False)
    p.add_argument("--precision_based", type=str2bool, default=False)
    p.add_argument("--use_mask", type=str2bool, default=False)
    p.add_argument("--use_annotations", type=str2bool, default=False)
    p.add_argument("--uvos", type=str2bool, default=False)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--streaming", type=str2bool, default=False,
                   help="bounded-memory dataset-wise protocol (two passes, "
                        "never concatenates the dataset's features)")
    p.add_argument("--sample_cap", type=int, default=None,
                   help="k-means fit sample size for --streaming "
                        "(default max(256*k, 16384), the faiss subsample rule)")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16 runs the preprocess and the ViT blocks "
                        "through the CUDA kernels; float32 is faithful")
    p.add_argument("--logging_directory", type=str, default=None,
                   help="write per-clip reordered/raw cluster-map gifs here "
                        "(reference evaluation.py:270-300)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda, and an error where there "
                        "is no card; pass cpu to run on the host)")
    return p


def _head_from_state_dict(sd: dict, feature_dim: int):
    """The projection head of a TimeT state dict (``feature_extractor.head.
    lin{i}.*``), or None."""
    from timetuning_tpu_torch.models.heads import ProjectionHead

    prefix = "feature_extractor.head."
    head_sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if not head_sd:
        return None
    layers = sorted(int(k.split(".")[0][3:]) for k in head_sd if k.endswith(".weight"))
    dims = tuple(int(head_sd[f"lin{i}.weight"].shape[0]) for i in layers)
    head = ProjectionHead(feature_dim, dims)
    head.load_state_dict(head_sd)
    return head


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from timetuning_tpu_torch.cli.propagate import default_device
    from timetuning_tpu_torch.data.loader import make_loader, sampling_mode
    from timetuning_tpu_torch.data.transforms import eval_preprocess_batch
    from timetuning_tpu_torch.eval.evaluator import Evaluator
    from timetuning_tpu_torch.models.registry import get_backbone

    device = default_device(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cdt = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    # prototype clustering needs the checkpoint's prototype bank and, for
    # TimeT checkpoints (prototypes in head space), its projection head
    sd = None
    if args.clustering_algorithm == "prototypes":
        if not args.model_path:
            raise SystemExit("--clustering_algorithm prototypes requires --model_path "
                             "(a TimeT checkpoint carrying the prototype bank)")
        from timetuning_tpu_torch.core.checkpoint import import_timet_pth

        sd = import_timet_pth(args.model_path)
        if "prototypes" not in sd:
            raise SystemExit("checkpoint has no prototype bank: use "
                             "--clustering_algorithm k-means for plain backbone weights")
    bb = get_backbone(args.architecture, None if sd is not None else args.model_path,
                      dtype=cdt, device="cpu")
    protos = head = None
    if sd is not None:
        prefix = "feature_extractor.backbone."
        bb.module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                                   if k.startswith(prefix)})
        protos = sd["prototypes"].numpy()
        head = _head_from_state_dict(sd, bb.feature_dim)
        want = bb.feature_dim if head is None else head.layer_dims[-1]
        if protos.shape[-1] != want:
            raise SystemExit(f"prototype dim {protos.shape[-1]} != feature dim {want}")
        if head is not None:
            head = head.to(device).eval()
    bb.module.to(device)
    res = bb.spatial_resolution(args.input_resolution)

    @torch.no_grad()
    def feature_fn(frames, want_attention=False):
        x = torch.as_tensor(np.asarray(frames)).to(device)
        x = eval_preprocess_batch(x, out_size=args.input_resolution, compute_dtype=cdt)
        f, attn = bb.apply(x, want_attention=bool(want_attention))
        return (f if head is None else head(f)), attn

    loader = make_loader(
        args.dataset, num_clip_frames=args.num_frames, batch_size=args.batch_size,
        sampling_mode=sampling_mode("UNIFORM"), shuffle=False,
        num_workers=args.num_workers, root=args.data_root, drop_last=False)
    ev = Evaluator(
        data_iter_factory=lambda: iter(loader), feature_fn=feature_fn,
        spatial_resolution=res, num_classes=args.num_clusters, involve_bg=True,
        clustering_algorithm=args.clustering_algorithm, prototypes=protos,
        uvos=args.uvos, ignore_index=None,
        logging_directory=args.logging_directory)
    score = ev.evaluate(
        many_to_one=args.many_to_one, evaluation_protocol=args.evaluation_protocol,
        eval_resolution=args.eval_resolution, num_clusters=args.num_clusters,
        use_mask=args.use_mask, use_annotations=args.use_annotations,
        precision_based=args.precision_based, streaming=args.streaming,
        sample_cap=args.sample_cap)
    print(f"score: {score}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
