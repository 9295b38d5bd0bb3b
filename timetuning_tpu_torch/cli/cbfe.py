"""CBFE CLI, the ``python cluster_based_foreground_extraction.py``
equivalent, on PyTorch.

Counterpart of ``timetuning_tpu/cli/cbfe.py`` (reference :281-372): k = 300
overclustering of the features at 448 input, the foreground masks tuned on
the trainaug split, then the Evaluator rerun on val with those masks. The
same flags and defaults, plus ``--device`` (the card unless ``--device
cpu``; an error where there is no card). Runs in f32, as the JAX CLI (which
has no dtype flag): the preprocess and the blocks take their plain paths.
Without ``--model_path`` the backbone's weights are a random init from
seed 0.

    python -m timetuning_tpu_torch.cli.cbfe --pascal_root VOC --architecture dino-s16
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from timetuning_tpu_torch.cli.train import str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("timetuning_tpu_torch.cbfe")
    p.add_argument("--architecture", type=str, default="dino-s16")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--pascal_root", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_clusters", type=int, default=300)
    p.add_argument("--input_resolution", type=int, default=448)
    p.add_argument("--resolution", type=int, default=100)
    p.add_argument("--eval_resolution", type=int, default=100)
    p.add_argument("--num_eval_clusters", type=int, default=21)
    p.add_argument("--many_to_one", type=str2bool, default=True)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda, and an error where there "
                        "is no card; pass cpu to run on the host)")
    return p


def make_feature_fn(bb, input_resolution: int, device):
    """frames [B, S, S, 3] uint8 -> (features [B, N, D], attention masks
    [B, r, r]): the eval preprocess with the ImageNet std, the backbone asked
    for its last block's attention, the CLS token dropped where the backbone
    has one, and ``process_attentions`` of that attention (timetuning_tpu/cli/cbfe.py:44-51)."""
    from timetuning_tpu_torch.data.transforms import IMAGENET_STD, eval_preprocess_batch
    from timetuning_tpu_torch.models.extractor import process_attentions

    res = bb.spatial_resolution(input_resolution)

    @torch.inference_mode()
    def feats_attn(frames_u8):
        x = eval_preprocess_batch(torch.as_tensor(np.asarray(frames_u8)).to(device),
                                  out_size=input_resolution, std=IMAGENET_STD)
        out = bb.module(x, want_attention=True)
        if out["attention"] is None:
            raise ValueError(f"cbfe: {bb.name} has no attention to take the "
                             "pseudo foreground from")
        feats = out["tokens"][:, 1:] if bb.drop_cls else out["tokens"]
        return feats, process_attentions(out["attention"], res)[:, 0]

    return feats_attn


def run_cbfe(args, log=print) -> dict:
    """CBFE and the masked Evaluator rerun; returns {"threshold",
    "train_jaccard", "val_jaccard", "val_bf", "masked_miou"} (reference
    cluster_based_foreground_extraction.py:281-348)."""
    from timetuning_tpu_torch.cli.propagate import default_device
    from timetuning_tpu_torch.data.pascal import pascal_loader
    from timetuning_tpu_torch.eval.cbfe import CBFEConfig, ClusterBasedForegroundExtraction
    from timetuning_tpu_torch.eval.evaluator import Evaluator
    from timetuning_tpu_torch.models.registry import get_backbone

    device = default_device(args)
    bb = get_backbone(args.architecture, args.model_path, device=device)
    res = bb.spatial_resolution(args.input_resolution)
    feats_attn = make_feature_fn(bb, args.input_resolution, device)

    def feature_fn(frames):
        feats, masks = feats_attn(frames)
        return feats[:, None], masks            # [B, 1, N, D], [B, r, r]

    train_loader = pascal_loader(args.batch_size, args.pascal_root, "trainaug",
                                 args.resolution, args.input_resolution)
    val_loader = pascal_loader(args.batch_size, args.pascal_root, "val",
                               args.resolution, args.input_resolution)
    cbfe = ClusterBasedForegroundExtraction(
        feature_fn, CBFEConfig(num_clusters=args.num_clusters,
                               resolution=args.resolution))
    result = cbfe.get_foreground_masks(train_loader, val_loader)
    log(f"threshold={result['threshold']} train_j={result['train_jaccard']:.4f} "
        f"val_j={result['val_jaccard']:.4f} val_bf={result['val_bf']:.4f}")

    # the masked Evaluator rerun (reference :340-348)
    def eval_feature_fn(frames, want_attention=False):
        return feats_attn(frames)[0], None

    ev = Evaluator(
        data_iter_factory=lambda: iter(val_loader), feature_fn=eval_feature_fn,
        spatial_resolution=res, num_classes=args.num_eval_clusters,
        involve_bg=True, fg_masks=result["fg_masks"][:, None], ignore_index=255)
    score = ev.evaluate(many_to_one=args.many_to_one, evaluation_protocol="dataset-wise",
                        eval_resolution=args.eval_resolution,
                        num_clusters=args.num_eval_clusters, use_mask=True)
    log(f"masked dataset-wise mIoU: {score}")
    return {
        "threshold": result["threshold"],
        "train_jaccard": float(result["train_jaccard"]),
        "val_jaccard": float(result["val_jaccard"]),
        "val_bf": float(result["val_bf"]),
        "masked_miou": float(score),
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # f32 is the faithful path: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run_cbfe(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
