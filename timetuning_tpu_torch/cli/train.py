"""Training CLI, the ``python time_tuning.py`` equivalent, on PyTorch.

Counterpart of ``timetuning_tpu/cli/train.py``: the same flags and defaults
(the reference parser, time_tuning.py:673-714, with booleans that parse:
``--use_queue true/false``), plus ``--device``. It runs on the card unless
given ``--device cpu``, and raises where there is no card.

``--multihost true`` makes the process a rank of a data-parallel run: it
initializes ``torch.distributed`` from ``torchrun``'s environment (the
counterpart of ``jax.distributed.initialize()``; NCCL on the card, gloo with
``--device cpu``) and runs on ``cuda:LOCAL_RANK``. ``--batch_size`` is per
rank; ``--zero1 true`` splits the optimizer state over the ranks.
``--tensor_parallel`` above 1 raises (ROADMAP.md queue 1 item 11c).

    python -m timetuning_tpu_torch.cli.train --data_root DAVIS --dataset davis \\
        --pascal_root VOC --batch_size 32
    torchrun --nproc_per_node 8 -m timetuning_tpu_torch.cli.train \\
        --multihost true --data_root DAVIS --dataset davis --batch_size 16
"""

from __future__ import annotations

import argparse


def str2bool(v: str) -> bool:
    """Copied from timetuning_tpu/cli/train.py:17-25 (that module imports
    jax): garbage is rejected rather than read as False."""
    s = str(v).lower()
    if s in ("1", "true", "yes", "y", "t"):
        return True
    if s in ("0", "false", "no", "n", "f"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("timetuning_tpu_torch.train")
    p.add_argument("--architecture", type=str, default="dino-s16")
    p.add_argument("--model_path", type=str, default=None,
                   help="pretrained backbone checkpoint (.pth)")
    p.add_argument("--dataset", type=str, default="ytvos")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--pascal_root", type=str, default=None)
    p.add_argument("--log_dir", type=str, default="logs")
    p.add_argument("--evaluation_protocol", type=str, default="dataset-wise",
                   choices=["frame-wise", "sample-wise", "dataset-wise"])
    p.add_argument("--EMA_decay", type=float, default=0.995)
    p.add_argument("--lr_scheduler", type=str, default="CosineAnnealingLR")
    p.add_argument("--head_lr", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--num_workers", type=int, default=10)
    p.add_argument("--num_clusters", type=int, default=200)
    p.add_argument("--input_resolution", type=int, default=224)
    p.add_argument("--many_to_one", type=str2bool, default=False)
    p.add_argument("--precision_based", type=str2bool, default=False)
    p.add_argument("--num_frames", type=int, default=4)
    p.add_argument("--n_last_frames", type=int, default=7)
    p.add_argument("--uvos", type=str2bool, default=False)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--size_mask_neighborhood", type=int, default=6)
    p.add_argument("--epsilon", type=float, default=0.05)
    p.add_argument("--sinkhorn_iterations", type=int, default=10)
    p.add_argument("--use_projection_head", type=str2bool, default=True)
    p.add_argument("--log_histograms", type=str2bool, default=False,
                   help="per-eval-epoch assignment histogram, entropy and "
                        "overlay gif artifacts (time_tuning.py:433-457)")
    p.add_argument("--streaming_eval", type=str2bool, default=False,
                   help="bounded-memory dataset-wise in-training eval")
    p.add_argument("--checkpoint_every_steps", type=int, default=None,
                   help="additional mid-epoch checkpoint cadence")
    p.add_argument("--handle_preemption", type=str2bool, default=True,
                   help="SIGTERM -> save a checkpoint and exit cleanly")
    p.add_argument("--opt_over_trainable", type=str2bool, default=True,
                   help="optimizer state and EMA over the trainable subtree "
                        "only; false keeps state for the full tree")
    p.add_argument("--use_queue", type=str2bool, default=False)
    p.add_argument("--queue_size", type=int, default=16384)
    p.add_argument("--use_mask", type=str2bool, default=False)
    p.add_argument("--use_teacher", type=str2bool, default=True)
    p.add_argument("--load_checkpoint", type=str2bool, default=False)
    p.add_argument("--regular_step", type=int, default=3)
    p.add_argument("--eval_every", type=int, default=4)
    p.add_argument("--eval_num_clusters", type=int, default=21,
                   help="k for the in-training Pascal eval (the reference "
                        "hardcodes 21, time_tuning.py:603)")
    p.add_argument("--unfreeze_layers", type=str, default="blocks.11,blocks.10",
                   help="comma-separated backbone subtrees to train (the "
                        "reference hardcodes the last two blocks, "
                        "time_tuning.py:195)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--debug_nans", type=str2bool, default=False)
    p.add_argument("--zero1", type=str2bool, default=False,
                   help="ZeRO-1 optimizer-state sharding across the data "
                        "ranks (more than one rank; requires "
                        "opt_over_trainable)")
    p.add_argument("--pack_path", type=str, default=None,
                   help="decode-once packed clip cache (.clippack); built "
                        "here on first use")
    p.add_argument("--fast_decode", type=str2bool, default=False,
                   help="JPEG DCT-domain reduced decode when the source is "
                        ">=2x decode_size")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="model-axis size of a (data, model) mesh: not ported "
                        "yet above 1")
    p.add_argument("--multihost", type=str2bool, default=False,
                   help="initialize torch.distributed from torchrun's "
                        "environment: one data-parallel rank a process")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda, and an error where there "
                        "is no card; pass cpu to run on the host)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from timetuning_tpu_torch.cli.propagate import default_device
    from timetuning_tpu_torch.core.train import TrainingConfig, run_training

    if args.multihost:
        from timetuning_tpu_torch.parallel.mesh import init_from_env

        device = init_from_env(args.device)
    else:
        device = default_device(args)
    if args.debug_nans:
        from timetuning_tpu_torch.runtime import enable_debug_nans

        enable_debug_nans(True)
    cfg = TrainingConfig(
        architecture=args.architecture, model_path=args.model_path,
        dataset=args.dataset, data_root=args.data_root,
        pascal_root=args.pascal_root, log_dir=args.log_dir,
        evaluation_protocol=args.evaluation_protocol,
        lr_scheduler=args.lr_scheduler, head_lr=args.head_lr,
        batch_size=args.batch_size, num_epochs=args.num_epochs,
        num_workers=args.num_workers, num_clusters=args.num_clusters,
        input_resolution=args.input_resolution, many_to_one=args.many_to_one,
        precision_based=args.precision_based, num_frames=args.num_frames,
        n_last_frames=args.n_last_frames, uvos=args.uvos, topk=args.topk,
        size_mask_neighborhood=args.size_mask_neighborhood,
        epsilon=args.epsilon, sinkhorn_iterations=args.sinkhorn_iterations,
        use_projection_head=args.use_projection_head,
        use_queue=args.use_queue, queue_size=args.queue_size,
        streaming_eval=args.streaming_eval,
        log_histograms=args.log_histograms,
        checkpoint_every_steps=args.checkpoint_every_steps,
        handle_preemption=args.handle_preemption,
        opt_over_trainable=args.opt_over_trainable, use_mask=args.use_mask,
        use_teacher=args.use_teacher, ema_decay=args.EMA_decay,
        load_checkpoint=args.load_checkpoint, regular_step=args.regular_step,
        eval_every=args.eval_every, eval_num_clusters=args.eval_num_clusters,
        unfreeze_layers=tuple(s.strip() for s in args.unfreeze_layers.split(",")
                              if s.strip()),
        seed=args.seed, compute_dtype=args.compute_dtype,
        pack_path=args.pack_path, zero1=args.zero1,
        tensor_parallel=args.tensor_parallel, fast_decode=args.fast_decode,
        device=str(device),
    )
    try:
        result = run_training(cfg)
    finally:
        if args.multihost:
            import torch.distributed as dist

            dist.destroy_process_group()
    print(f"done: run_dir={result['run_dir']} best={result['best_score']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
