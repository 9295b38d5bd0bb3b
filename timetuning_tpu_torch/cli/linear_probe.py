"""Linear-probe CLI, on PyTorch: the ``python linear_finetune.py``
equivalent (reference linear_finetune.py:55-96).

Counterpart of ``timetuning_tpu/cli/linear_probe.py``: the same flags and
defaults, plus ``--device``. The frozen backbone runs in f32 (on the card a
ViT over 1024 tokens, dino-s8 at the default 448 input, runs its attention
through the flash kernel in f32), the images go through the eval preprocess
with the canonical ImageNet std, and the head trains by
``eval/linear_probe.LinearProbeTrainer``. Without ``--model_path`` the
backbone's weights are a random init from seed 0.

    python -m timetuning_tpu_torch.cli.linear_probe --pascal_root VOC \\
        --architecture dino-s8 --input_resolution 448

``train_and_validate`` takes any iterables of (uint8 images [B, S, S, 3],
uint8 masks [B, s, s]) batches; ``run_linear_probe`` feeds it from the Pascal
VOC loader (the JAX package's framework-free ``data/pascal.py``).
"""

from __future__ import annotations

import argparse

import torch

from timetuning_tpu_torch._host import host_module
from timetuning_tpu_torch.cli.propagate import default_device
from timetuning_tpu_torch.data.transforms import IMAGENET_STD, eval_preprocess_batch
from timetuning_tpu_torch.eval.linear_probe import LinearProbeConfig, LinearProbeTrainer
from timetuning_tpu_torch.models.registry import Backbone, get_backbone


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("timetuning_tpu_torch.linear_probe")
    p.add_argument("--architecture", type=str, default="dino-s16")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--pascal_root", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_classes", type=int, default=21)
    p.add_argument("--num_epochs", type=int, default=50)
    p.add_argument("--input_resolution", type=int, default=448)
    p.add_argument("--mask_size", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda when available, else cpu)")
    return p


def train_and_validate(args, bb: Backbone, train_loader, val_loader,
                       device: torch.device | str, log=print) -> dict:
    """Train the head for ``--num_epochs`` epochs, validating after each;
    returns {"best_miou", "final_miou"} (reference linear_finetune.py:55-89)."""

    @torch.no_grad()
    def feature_fn(frames):
        # eval preprocess with the canonical ImageNet std (leoloader.py:246-251)
        x = eval_preprocess_batch(torch.as_tensor(frames).to(device),
                                  out_size=args.input_resolution, std=IMAGENET_STD)
        return bb.apply(x)[0].float()

    cfg = LinearProbeConfig(num_classes=args.num_classes,
                            mask_size=args.mask_size,
                            num_epochs=args.num_epochs, lr=args.lr)
    tr = LinearProbeTrainer(feature_fn, bb.spatial_resolution(args.input_resolution),
                            cfg, steps_per_epoch=len(train_loader))
    best = miou = 0.0
    for epoch in range(args.num_epochs):
        loss = tr.train_epoch(train_loader)
        miou = tr.validate(val_loader)
        best = max(best, miou)
        log(f"epoch {epoch}: loss={loss:.4f} val mIoU={miou:.4f} best={best:.4f}")
    return {"best_miou": best, "final_miou": miou}


def run_linear_probe(args, log=print) -> dict:
    pascal = host_module("data.pascal")
    device = default_device(args)
    bb = get_backbone(args.architecture, args.model_path, dtype=torch.float32,
                      device=device)
    train_loader = pascal.pascal_loader(
        args.batch_size, args.pascal_root, "trainaug", args.mask_size,
        args.input_resolution)
    val_loader = pascal.pascal_loader(
        args.batch_size, args.pascal_root, "val", args.mask_size,
        args.input_resolution)
    return train_and_validate(args, bb, train_loader, val_loader, device, log)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # the backbone is held to the reference in f32: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run_linear_probe(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
