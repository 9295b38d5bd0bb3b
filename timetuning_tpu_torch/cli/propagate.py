"""Semi-supervised mask propagation CLI (DAVIS J&F), on PyTorch.

Counterpart of ``timetuning_tpu/cli/propagate.py``, the ``python
mask_propagation.py`` equivalent (reference mask_propagation.py:717-870:
bs=1, 25 uniform frames, n_last=4, neighbourhood 12, topk 5, uvos
binarisation). Same flags and defaults, plus ``--device``. Without
``--model_path`` the backbone's weights are a random init from seed 0.

    python -m timetuning_tpu_torch.cli.propagate --data_root DAVIS \\
        --compute_dtype bfloat16 --clip_batch 2

Supported runs include ``--architecture dino-s16`` at 224 and
``--architecture dino-s8 --input_resolution 448`` (56x56 patches, 3,137
tokens: the ViT's long-token path, the flash kernel and the row kernels in
bf16, the flash kernel in f32), each in either compute dtype.

``--use_optical_flow`` scores the Farneback flow baseline instead
(``eval/optical_flow``, OpenCV on the host): the first mask warped from
frame to frame at S x S, no backbone forward.

The per-group compute (preprocess -> ViT -> propagate -> upsample -> argmax)
is ``propagate_clip_group``, which takes in-memory uint8 clips;
``group_program`` makes it one CUDA graph a group shape on the card (the
JAX CLI's jitted ``extract`` + ``propagate_batch``); ``evaluate_clips`` adds
the grouping and the scoring (J&F, mIoU under a clustering protocol,
propagation J), and ``run_propagation`` feeds it from the dataset loader.
"""

from __future__ import annotations

import argparse
from typing import Iterable

import numpy as np
import torch

from timetuning_tpu_torch.cli.train import str2bool
from timetuning_tpu_torch.data.transforms import eval_preprocess_batch
from timetuning_tpu_torch.eval.vos import evaluate_sequence, j_and_f
from timetuning_tpu_torch.models.registry import Backbone, get_backbone
from timetuning_tpu_torch.ops.propagation import propagate_labels_batch
from timetuning_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from timetuning_tpu_torch.ops.util import pad_to_multiple


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("timetuning_tpu_torch.propagate")
    p.add_argument("--architecture", type=str, default="dino-s16")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--dataset", type=str, default="davis_val")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--num_frames", type=int, default=25)
    p.add_argument("--n_last_frames", type=int, default=4)
    p.add_argument("--size_mask_neighborhood", type=int, default=12)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--input_resolution", type=int, default=224)
    p.add_argument("--uvos", type=str2bool, default=True)
    p.add_argument("--use_optical_flow", type=str2bool, default=False)
    p.add_argument("--metric", type=str, default="jf",
                   choices=["jf", "miou", "propagation"])
    p.add_argument("--evaluation_protocol", type=str, default="frame-wise",
                   choices=["frame-wise", "sample-wise", "dataset-wise"])
    p.add_argument("--many_to_one", type=str2bool, default=False)
    p.add_argument("--num_clusters", type=int, default=10)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16 runs the preprocess, the ViT blocks and the "
                        "propagation through the CUDA kernels (the perf "
                        "path); float32 is faithful to the reference")
    p.add_argument("--clip_batch", type=int, default=1,
                   help="clips per device dispatch; metrics do not depend "
                        "on it")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda, and an error where there "
                        "is no card; pass cpu to run on the host)")
    return p


def compute_dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32


def first_frame_onehot(ann0: np.ndarray, res: int, K: int) -> np.ndarray:
    """[S, S] object-id map of frame 0 -> [K, res*res] one-hot at the patch
    grid (nearest downscale)."""
    first = resize_nearest(torch.from_numpy(ann0[None].astype(np.float32)),
                           (res, res))[0].numpy().astype(np.int64)
    return np.eye(K, dtype=np.float32)[first].T.reshape(K, -1)


@torch.inference_mode()
def propagate_clip_group(bb: Backbone, frames: torch.Tensor,
                         first_onehots: torch.Tensor, *, input_resolution: int,
                         n_last: int, radius: int, topk: int,
                         dtype: torch.dtype) -> torch.Tensor:
    """frames [CB, T, H, W, 3] uint8 and first_onehots [CB, K, N] on the
    compute device -> predicted object ids [CB, T-1, S, S] (int64)."""
    CB, T = frames.shape[:2]
    S = input_resolution
    x = eval_preprocess_batch(frames.reshape((CB * T,) + frames.shape[2:]),
                              out_size=S, compute_dtype=dtype)
    feats, _ = bb.apply(x)
    feats = feats.reshape((CB, T) + feats.shape[1:])
    segs = propagate_labels_batch(feats, first_onehots, n_last=n_last,
                                  radius=radius, topk=topk)
    B, T1, K, _ = segs.shape
    res = bb.spatial_resolution(S)
    up = resize_bilinear(segs.reshape(B * T1, K, res, res), (S, S))
    return up.argmax(dim=1).reshape(B, T1, S, S)


def group_program(args, bb: Backbone, graphed: bool = True):
    """``propagate_clip_group`` at ``args``' settings as a callable
    ``(frames, first_onehots) -> predicted ids``: on the card one CUDA graph
    a (group shape, K) (runtime.CapturedCall), whose output stays valid
    until the program's next call; eagerly with ``graphed=False`` or on CPU
    tensors."""
    from timetuning_tpu_torch.runtime import CapturedCall

    def group(frames, onehots):
        return propagate_clip_group(
            bb, frames, onehots, input_resolution=args.input_resolution,
            n_last=args.n_last_frames, radius=args.size_mask_neighborhood,
            topk=args.topk, dtype=compute_dtype(args))

    return CapturedCall(group) if graphed else group


def evaluate_clips(args, bb: Backbone,
                   clips: Iterable[tuple[np.ndarray, np.ndarray]],
                   device: torch.device | str, metrics: tuple = ("jf",),
                   program=None) -> dict:
    """Propagate the first-frame masks through ``clips`` ((frames [T, H, W, 3]
    uint8, annotations [T, h, w]) pairs) in groups of ``--clip_batch`` and
    score the requested metrics: ``{"jf": {"J", "F", "J&F"}, "miou": float,
    "propagation": float}``. ``program``: the ``group_program`` of ``args``
    and ``bb`` to run the groups (its graphs outlive this call); None makes
    a graphed one."""
    S = args.input_resolution
    if program is None:
        program = group_program(args, bb)
    res = bb.spatial_resolution(S)
    CB = max(1, int(args.clip_batch))
    sequences: list[dict] = []
    all_gt, all_pred = [], []
    group: list = []                                  # [(frames, ann, K)]

    def score_clip(ann: np.ndarray, preds: np.ndarray) -> None:
        # the official DAVIS semi-supervised protocol scores masks[1:-1]:
        # the GT-given first frame and the last frame are excluded; object
        # ids come from the full ground truth. mIoU and propagation J keep
        # every predicted frame, as the reference's evaluate_localizations
        all_gt.append(ann[1:])
        all_pred.append(preds)
        obj_ids = [int(i) for i in np.unique(ann) if i != 0]
        sequences.append(
            evaluate_sequence(preds[:-1], ann[1:-1], obj_ids=obj_ids))

    def flush_group() -> None:
        if not group:
            return
        # one K per dispatch, the group max (padded channels are all-zero and
        # never win the argmax); a short group is padded with repeats
        K = max(k for _, _, k in group)
        nb = len(group)
        fr = np.stack([f for f, _, _ in group] + [group[-1][0]] * (CB - nb))
        onehots = [first_frame_onehot(ann[0], res, K) for _, ann, _ in group]
        oh = np.stack(onehots + [onehots[-1]] * (CB - nb))
        preds = program(torch.from_numpy(fr).to(device), torch.from_numpy(oh).to(device))
        for (_, ann, _), pr in zip(group, preds[:nb].cpu().numpy()):
            score_clip(ann, pr)
        group.clear()

    for frames, annots in clips:
        if args.uvos:
            annots = (annots > 0).astype(np.uint8)
        ann = resize_nearest(torch.from_numpy(annots.astype(np.float32)),
                             (S, S)).numpy().astype(np.int64)
        # K rounded up to a multiple of 4, as the JAX CLI (one program per K)
        K = pad_to_multiple(max(int(ann.max()) + 1, 2), 4)
        if args.use_optical_flow:
            # the Farneback baseline on the host (timetuning_tpu/cli/propagate.py:171-181):
            # frames resized INTER_LINEAR to S x S, the first mask warped along
            import cv2

            from timetuning_tpu_torch.eval.optical_flow import propagate_flow

            frames_s = np.stack([cv2.resize(f, (S, S), interpolation=cv2.INTER_LINEAR)
                                 for f in frames])
            score_clip(ann, propagate_flow(frames_s, ann[0]))
            continue
        group.append((frames, ann, K))
        if len(group) == CB:
            flush_group()
    flush_group()
    out = {}
    if "jf" in metrics:
        out["jf"] = j_and_f(sequences)
    if "miou" in metrics or "propagation" in metrics:
        from timetuning_tpu_torch.eval.evaluator import (
            evaluate_localizations,
            evaluate_propagation,
        )
        from timetuning_tpu_torch.eval.metrics import PredsmIoU

        gts, preds = np.stack(all_gt), np.stack(all_pred)
        if "miou" in metrics:
            # the reference's scoring (mask_propagation.py:754, 841):
            # PredsmIoU(num_clusters, 10, involve_bg=False) under the protocol
            out["miou"] = evaluate_localizations(
                PredsmIoU(args.num_clusters, 10, involve_bg=False), gts, preds,
                args.evaluation_protocol, many_to_one=bool(args.many_to_one))
        if "propagation" in metrics:
            out["propagation"] = evaluate_propagation(
                PredsmIoU(256, 256, involve_bg=True), gts, preds)
    return out


def default_device(args) -> torch.device:
    """``--device`` when given; else the card, and an error where there is
    none: the CLIs never take the CPU without being asked to."""
    from timetuning_tpu_torch.runtime import resolve_device

    return resolve_device(args.device)


def run_propagation(args, metrics: tuple = ("jf",)) -> dict:
    """Propagate GT first-frame masks through every clip of the dataset and
    score the requested metrics (``jf``, ``miou``, ``propagation``)."""
    from timetuning_tpu_torch.data.loader import make_loader, sampling_mode

    device = default_device(args)
    bb = get_backbone(args.architecture, args.model_path,
                      dtype=compute_dtype(args), device=device)
    loader = make_loader(
        args.dataset, num_clip_frames=args.num_frames, batch_size=1,
        sampling_mode=sampling_mode("UNIFORM"), shuffle=False,
        num_workers=args.num_workers, root=args.data_root, drop_last=False,
    )
    clips = ((frames[0], annots[0]) for frames, annots, _ in loader)
    return evaluate_clips(args, bb, clips, device, metrics)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # the f32 path is the faithful one: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = run_propagation(args, metrics=(args.metric,))
    if args.metric == "jf":
        print(f"J&F: {results['jf']}")
    elif args.metric == "propagation":
        print(f"propagation J: {results['propagation']}")
    else:
        print("mIoU:", results["miou"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
