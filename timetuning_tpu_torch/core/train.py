"""The TimeT training driver.

Counterpart of ``timetuning_tpu/core/train.py`` (reference ``time_tuning()``
and its launcher, time_tuning.py:508-717): the model, data and optimizer
assembly, the epoch loop with a checkpoint at the top of every epoch, the
Pascal VOC clustering eval every ``eval_every`` epochs with the best model
exported, and the per-step loss log.

One process on one device (the card unless ``device="cpu"``): the uint8
host batch is copied from pinned memory on a side stream while the previous
step runs, then augmented (data/transforms.apply_augment) and stepped
(core/timet) on the device. Every step's randomness (the augmentation's
draws and the queue's choice) comes from ``step_generator(seed, step)``, so
a resumed run draws what the uninterrupted run drew at the same step, and no
generator state is checkpointed. The data-parallel, ZeRO-1, tensor-parallel
and multi-host forms of the JAX driver are not ported yet (ROADMAP.md queue
1 item 11): their options raise.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Any

import numpy as np
import torch

from timetuning_tpu_torch.core.checkpoint import (
    export_best,
    find_last_run_directory,
    load_checkpoint,
    load_checkpoint_meta,
    make_run_directory,
    save_checkpoint,
)
from timetuning_tpu_torch.core.optimizer import swav_optimizer
from timetuning_tpu_torch.core.timet import (
    TimeT,
    TimeTConfig,
    init_state,
    make_train_step,
)
from timetuning_tpu_torch.data.transforms import (
    IMAGENET_STD,
    AugmentConfig,
    apply_augment,
    draw_augment_params,
    eval_preprocess_batch,
)
from timetuning_tpu_torch.obs.logging import MetricsWriter, dump_config, make_file_logger
from timetuning_tpu_torch.runtime import resolve_device

PARALLEL_ITEM = "ROADMAP.md queue 1 item 11, 'Parallel axes'"


@dataclasses.dataclass
class TrainingConfig:
    """Flag surface of the reference trainer (time_tuning.py:673-714); the
    JAX ``TrainingConfig``'s fields and defaults, plus ``device``."""

    architecture: str = "dino-s16"
    model_path: str | None = None           # pretrained backbone ckpt (.pth)
    dataset: str = "ytvos"
    data_root: str | None = None
    pascal_root: str | None = None          # eval dataset (time_tuning.py:596)
    log_dir: str = "logs"
    evaluation_protocol: str = "dataset-wise"
    # only the exact string "CosineAnnealingLR" enables the cosine schedule
    # (time_tuning.py:383); anything else means a constant lr
    lr_scheduler: str = "CosineAnnealingLR"
    head_lr: float = 1e-4
    batch_size: int = 128
    num_epochs: int = 100
    num_workers: int = 10
    num_clusters: int = 200
    input_resolution: int = 224
    eval_resolution: int | None = None      # default input/2 (:603)
    many_to_one: bool = False
    precision_based: bool = False
    num_frames: int = 4
    uvos: bool = False
    topk: int = 5
    size_mask_neighborhood: int = 6
    n_last_frames: int = 7                  # effective get_loss default
    epsilon: float = 0.05
    sinkhorn_iterations: int = 10           # effective get_loss default
    use_projection_head: bool = True
    use_queue: bool = False
    queue_size: int = 16384
    use_mask: bool = False
    use_teacher: bool = True
    ema_decay: float = 0.995
    load_checkpoint: bool = False
    regular_step: int = 3
    eval_every: int = 4
    decode_size: int = 256
    seed: int = 1
    head_dims: tuple = (1024, 1024, 512, 256)
    unfreeze_layers: tuple = ("blocks.11", "blocks.10")
    compute_dtype: str = "bfloat16"
    eval_num_clusters: int = 21             # Pascal (:603)
    max_steps_per_epoch: int | None = None  # test hook
    use_tensorboard: bool = True
    num_devices: int | None = None          # more than one: not ported yet
    streaming_eval: bool = False            # bounded-memory dataset-wise eval
    checkpoint_every_steps: int | None = None  # mid-epoch periodic saves
    handle_preemption: bool = True          # SIGTERM -> save + clean exit
    # optimizer state and EMA over the trainable subtree only; False keeps
    # state for the full tree (checkpoints load into either)
    opt_over_trainable: bool = True
    log_histograms: bool = False
    zero1: bool = False                     # not ported yet
    pack_path: str | None = None            # decode-once packed clip cache
    fast_decode: bool = False
    tensor_parallel: int = 1                # above 1: not ported yet
    device: str | None = None               # None: the card, or an error


def frozen_trunk_split(unfreeze_layers, backbone_module) -> int | None:
    """Largest k such that blocks [0, k) are all frozen, which enables the
    shared-trunk step (TimeTConfig.frozen_trunk_blocks); only for ViT
    backbones whose unfreeze patterns are all block names."""
    from timetuning_tpu_torch.models.vit import VisionTransformer

    if not isinstance(backbone_module, VisionTransformer):
        return None
    idxs = []
    for u in unfreeze_layers:
        m = re.fullmatch(r"blocks[._](\d+)", str(u))
        if not m:
            return None  # a non-block unfreeze could touch the trunk
        idxs.append(int(m.group(1)))
    if not idxs:
        return None
    lo = min(idxs)
    depth = backbone_module.config.depth
    if lo <= 0 or lo >= depth or max(idxs) >= depth:
        return None
    return lo


def default_eval_resolution(cfg: TrainingConfig) -> int:
    """time_tuning.py:603: input/2 for the dataset-wise protocol only;
    ``eval_resolution`` overrides either."""
    return cfg.eval_resolution or (
        cfg.input_resolution // 2
        if cfg.evaluation_protocol == "dataset-wise"
        else cfg.input_resolution)


def build_model(cfg: TrainingConfig, device: torch.device | str = "cpu"):
    """(TimeT on ``device`` with weights drawn from ``cfg.seed``, the
    pretrained backbone weights to graft or None, the patch grid's side)."""
    from timetuning_tpu_torch.models.extractor import FeatureExtractor
    from timetuning_tpu_torch.models.registry import get_backbone

    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    bb = get_backbone(cfg.architecture, cfg.model_path, dtype=dtype, device="cpu")
    pretrained = None
    if cfg.model_path:
        pretrained = {f"feature_extractor.backbone.{k}": v.clone()
                      for k, v in bb.module.state_dict().items()}
    head_dims = tuple(cfg.head_dims) if cfg.use_projection_head else ()
    fe = FeatureExtractor(bb.module, bb.feature_dim, head_dims, drop_cls=bb.drop_cls)
    model = TimeT(fe, n_prototypes=cfg.num_clusters,
                  prototype_dim=None if head_dims else bb.feature_dim)
    model.init_weights(torch.Generator().manual_seed(cfg.seed))
    return model.to(device), pretrained, bb.spatial_resolution(cfg.input_resolution)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The host generator of global step ``step``: a pure function of
    (seed, step), forked from the model's init stream by a constant."""
    s = np.random.SeedSequence([seed, 0x57E9, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(s))


def make_full_step(model: TimeT, tcfg: TimeTConfig, opt, aug_cfg: AugmentConfig,
                   trainable_mask=None, opt_over_trainable: bool | None = None):
    """uint8 batch -> augment -> TimeT step on the model's device. Returns
    ``full(state, frames_u8, src_sizes, gray_means, generator)``: the
    augmentation's values are drawn from ``generator`` first, then the step
    draws the queue's choice from it."""
    if opt_over_trainable is None:
        opt_over_trainable = trainable_mask is not None
    base_step = make_train_step(model, tcfg, opt, trainable_mask=trainable_mask,
                                opt_over_trainable=opt_over_trainable)

    def full(state, frames_u8, src_sizes, gray_means, generator):
        B, F = frames_u8.shape[:2]
        params = draw_augment_params(generator, B, F, aug_cfg)
        if frames_u8.is_cuda:
            params = params.pin_memory().to(frames_u8.device, non_blocking=True)
        clips, _ = apply_augment(frames_u8, params, aug_cfg, src_sizes, gray_means)
        return base_step(state, clips, generator)

    return full


def make_eval_feature_fn(model: TimeT, input_resolution: int):
    """The in-training eval's feature function (the JAX driver's
    ``feature_fn_jit``, core/train.py:838-856): uint8 frames [N, H, W, 3] ->
    (patch features [N, P, D], last attention or None) on the model's
    device, no grad. The frames are resized and normalised in the model's
    compute dtype (the preprocess kernel for bf16 on the card), which is
    where the JAX model rounds its f32 input."""
    device = model.prototypes.device
    dtype = getattr(getattr(model.feature_extractor.backbone, "config", None),
                    "dtype", torch.float32)

    @torch.no_grad()
    def feature_fn(frames, want_attention: bool = False):
        x = torch.as_tensor(np.asarray(frames) if not torch.is_tensor(frames)
                            else frames).to(device)
        x = eval_preprocess_batch(x, out_size=input_resolution, std=IMAGENET_STD,
                                  compute_dtype=dtype)
        return model(x, use_head=False, want_attention=bool(want_attention))

    return feature_fn


def make_diagnostics_scores_fn(model: TimeT, input_resolution: int):
    """(normalised images, prototype scores) of uint8 frames, for the
    training diagnostics: f32 preprocessing as the JAX driver's."""
    device = model.prototypes.device

    @torch.no_grad()
    def scores_fn(frames_u8):
        x = eval_preprocess_batch(torch.as_tensor(np.asarray(frames_u8)).to(device),
                                  out_size=input_resolution, std=IMAGENET_STD)
        feats, _ = model(x, use_head=True)
        return x, model.similarity(feats)

    return scores_fn


def log_training_diagnostics(scores_fn, eval_loader, writer, run_dir: str,
                             epoch: int, cfg: TrainingConfig,
                             spatial_res: int) -> float:
    """Prototype-assignment histogram + entropy scalars and an overlay gif
    over the eval set (reference ``get_similarity_histogram`` /
    ``log_assignment_histogram`` and overlays, time_tuning.py:433-457,
    305-351): a second forward pass over the eval loader, as the
    reference's. Returns the entropy."""
    from timetuning_tpu_torch.data.transforms import IMAGENET_MEAN
    from timetuning_tpu_torch.obs.histograms import (
        assignment_histogram,
        log_assignment_histogram,
    )
    from timetuning_tpu_torch.obs.viz import clip_overlay_frames, write_gif

    hist = np.zeros(cfg.num_clusters, np.int64)
    overlay = None
    for frames, _masks in eval_loader:
        x, s = scores_fn(frames)
        hist += assignment_histogram(s, cfg.num_clusters).cpu().numpy()
        if overlay is None:
            n = min(8, s.shape[0])
            seg = s[:n].argmax(-1).reshape(n, spatial_res, spatial_res).cpu().numpy()
            overlay = clip_overlay_frames(x[:n].float().cpu().numpy(), seg,
                                          IMAGENET_MEAN, IMAGENET_STD)
    ent = log_assignment_histogram(writer, hist, epoch)
    if overlay:
        art_dir = os.path.join(run_dir, "artifacts")
        os.makedirs(art_dir, exist_ok=True)
        write_gif(overlay, os.path.join(art_dir, f"assignments_epoch{epoch}.gif"))
    return ent


def _check_single_device(cfg: TrainingConfig) -> None:
    if cfg.tensor_parallel < 1:
        raise ValueError(f"tensor_parallel must be >= 1, got {cfg.tensor_parallel}")
    for flag, on in (("num_devices > 1", (cfg.num_devices or 1) > 1),
                     ("zero1", cfg.zero1),
                     ("tensor_parallel > 1", cfg.tensor_parallel > 1)):
        if on:
            raise NotImplementedError(
                f"TrainingConfig.{flag}: the multi-device driver is not ported "
                f"yet ({PARALLEL_ITEM})")


def run_training(cfg: TrainingConfig) -> dict[str, Any]:
    _check_single_device(cfg)
    device = resolve_device(cfg.device)
    from timetuning_tpu_torch.data.datasets import SamplingMode
    from timetuning_tpu_torch.data.loader import (
        device_prefetch,
        host_batch_to_device,
        make_loader,
    )

    run_dir = (find_last_run_directory(cfg.log_dir) if cfg.load_checkpoint
               else None) or make_run_directory(cfg.log_dir)
    dump_config(dataclasses.asdict(cfg), run_dir)
    writer = MetricsWriter(run_dir, use_tensorboard=cfg.use_tensorboard)
    logger = make_file_logger("train", run_dir)

    model, pretrained, spatial_res = build_model(cfg, device)

    if cfg.pack_path and not (os.path.exists(cfg.pack_path)
                              and os.path.exists(cfg.pack_path + ".index.json")):
        from timetuning_tpu_torch.native import build_clip_pack

        plain = make_loader(cfg.dataset, num_clip_frames=cfg.num_frames,
                            batch_size=cfg.batch_size, root=cfg.data_root,
                            decode_size=cfg.decode_size, fast_decode=cfg.fast_decode)
        t0 = time.time()
        build_clip_pack(plain.dataset, cfg.pack_path)
        logger.info("clip pack built at %s in %.1fs", cfg.pack_path, time.time() - t0)
    loader = make_loader(
        cfg.dataset, num_clip_frames=cfg.num_frames, batch_size=cfg.batch_size,
        regular_step=cfg.regular_step, sampling_mode=SamplingMode.UNIFORM,
        shuffle=True, num_workers=cfg.num_workers, root=cfg.data_root,
        decode_size=cfg.decode_size, pack_path=cfg.pack_path,
        fast_decode=cfg.fast_decode, seed=cfg.seed,
        # the SSL loss never reads annotations
        load_annotations=False,
    )
    if len(loader) == 0:
        raise ValueError(
            f"dataset '{cfg.dataset}' at {cfg.data_root} yields no batches at "
            f"batch_size={cfg.batch_size}: fewer videos than the batch; lower "
            "--batch_size")
    steps_per_epoch = len(loader)
    if cfg.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, cfg.max_steps_per_epoch)

    tcfg = TimeTConfig(
        n_prototypes=cfg.num_clusters, epsilon=cfg.epsilon,
        sinkhorn_iterations=cfg.sinkhorn_iterations,
        n_last_frames=cfg.n_last_frames,
        size_mask_neighborhood=cfg.size_mask_neighborhood, topk=cfg.topk,
        use_teacher=cfg.use_teacher, use_queue=cfg.use_queue,
        queue_size=cfg.queue_size, mask_features=cfg.use_mask,
        ema_start=cfg.ema_decay, num_epochs=cfg.num_epochs,
        steps_per_epoch=steps_per_epoch, spatial_resolution=spatial_res,
        frozen_trunk_blocks=frozen_trunk_split(cfg.unfreeze_layers,
                                               model.feature_extractor.backbone),
    )
    if cfg.use_queue and tcfg.queue_size <= 0:
        raise ValueError(f"--queue_size {cfg.queue_size} gives the feature queue "
                         "no rows")

    opt, trainable_mask = swav_optimizer(
        model, lr=cfg.head_lr, backbone_lr=cfg.head_lr / 10,
        num_epochs=cfg.num_epochs, steps_per_epoch=steps_per_epoch,
        unfreeze_layers=cfg.unfreeze_layers,
        use_cosine_lr=cfg.lr_scheduler == "CosineAnnealingLR",
        opt_over_trainable=cfg.opt_over_trainable)
    state = init_state(model, tcfg, opt, pretrained_params=pretrained,
                       trainable_mask=trainable_mask if cfg.opt_over_trainable else None)
    start_epoch = 0
    resume_skip = 0
    best_score = -1.0
    if cfg.load_checkpoint:
        state, start_epoch = load_checkpoint(run_dir, state)
        meta = load_checkpoint_meta(run_dir) or {}
        # a mid-epoch checkpoint (checkpoint_every_steps, preemption) holds
        # step > start_epoch * steps_per_epoch: skip the batches of the epoch
        # it already trained (the shuffle is keyed by (seed, epoch)), unless
        # the batching changed since the save
        if meta.get("steps_per_epoch") == steps_per_epoch:
            resume_skip = min(max(0, state.step - start_epoch * steps_per_epoch),
                              steps_per_epoch)
        if "best_score" in meta:
            best_score = float(meta["best_score"])
        if cfg.use_queue and state.queue is not None and (
                state.queue.shape[0] != tcfg.queue_size
                or meta.get("queue_rows_per_device", tcfg.queue_size) != tcfg.queue_size):
            logger.warning("feature queue reset on restore: checkpoint has %d rows, "
                           "this run needs %d; it refills during training",
                           state.queue.shape[0], tcfg.queue_size)
            state.queue = torch.zeros(tcfg.queue_size, state.queue.shape[1],
                                      device=device)
            state.queue_fill = 0

    aug_cfg = AugmentConfig(out_size=cfg.input_resolution)
    step_fn = make_full_step(model, tcfg, opt, aug_cfg, trainable_mask=trainable_mask,
                             opt_over_trainable=cfg.opt_over_trainable)

    evaluator_factory = None
    eval_res = default_eval_resolution(cfg)
    if cfg.pascal_root:
        from timetuning_tpu_torch.data.pascal import pascal_loader
        from timetuning_tpu_torch.eval.evaluator import Evaluator

        eval_loader = pascal_loader(60, cfg.pascal_root, "val", eval_res,
                                    cfg.input_resolution)
        feature_fn = make_eval_feature_fn(model, cfg.input_resolution)

        def evaluator_factory():
            return Evaluator(
                data_iter_factory=lambda: iter(eval_loader), feature_fn=feature_fn,
                spatial_resolution=spatial_res, num_classes=cfg.eval_num_clusters,
                involve_bg=True, uvos=cfg.uvos, ignore_index=255, logger=logger)

    # on SIGTERM: finish the step in flight, save, and return, so that
    # --load_checkpoint resumes (beyond the reference, which has none)
    preempt = {"flag": False}
    prev_handler = None
    if cfg.handle_preemption:
        import signal
        import threading

        if threading.current_thread() is threading.main_thread():
            prev_handler = signal.signal(signal.SIGTERM,
                                         lambda *_: preempt.update(flag=True))

    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def to_device(batch):
        frames = host_batch_to_device(batch[0], device)
        sizes = getattr(batch, "orig_sizes", None)
        if sizes is not None:
            sizes = host_batch_to_device(sizes, device)
        gmeans = getattr(batch, "gray_means", None)
        if gmeans is None:
            # NaN: the augmentation takes the buffer's own mean
            gmeans = np.full(batch[0].shape[:2], np.nan, np.float32)
        return frames, sizes, host_batch_to_device(gmeans, device)

    global_step = state.step
    last_eval = last_loss = None
    mem_reported = False
    diag_scores_fn = None
    ckpt_meta = {
        "world_size": 1, "queue_rows_per_device": tcfg.queue_size,
        "tensor_parallel": 1,
        "opt_layout": "trainable-subtree" if cfg.opt_over_trainable else "full-tree",
        "best_score": best_score, "steps_per_epoch": steps_per_epoch,
    }

    def log_pending(pending):
        nonlocal last_loss
        pstep, pmetrics = pending
        last_loss = float(pmetrics["loss"])
        writer.scalar("Loss/train", last_loss, pstep)
        writer.scalar("momentum", float(pmetrics["momentum"]), pstep)

    def finish(preempted: bool = False):
        if prev_handler is not None:
            import signal

            signal.signal(signal.SIGTERM, prev_handler)
        writer.close()
        return {"run_dir": run_dir, "final_loss": last_loss,
                "best_score": best_score, "last_eval": last_eval,
                "global_step": global_step, "state": state,
                "preempted": preempted}

    for epoch in range(start_epoch, cfg.num_epochs):
        save_checkpoint(state, run_dir, epoch, meta=ckpt_meta)
        loader.set_epoch(epoch)
        # a resumed mid-epoch checkpoint skips this epoch's eval: the
        # uninterrupted run already scored it before the interruption
        do_eval = (evaluator_factory is not None and epoch % cfg.eval_every == 0
                   and not (epoch == start_epoch and resume_skip > 0))
        if do_eval:
            score = evaluator_factory().evaluate(
                many_to_one=cfg.many_to_one,
                evaluation_protocol=cfg.evaluation_protocol,
                eval_resolution=eval_res, num_clusters=cfg.eval_num_clusters,
                use_mask=cfg.use_mask, precision_based=cfg.precision_based,
                streaming=cfg.streaming_eval)
            writer.scalar("Scores/localization", score, epoch)
            last_eval = score
            if cfg.log_histograms:
                if diag_scores_fn is None:
                    diag_scores_fn = make_diagnostics_scores_fn(model, cfg.input_resolution)
                log_training_diagnostics(diag_scores_fn, eval_loader, writer,
                                         run_dir, epoch, cfg, spatial_res)
            if score > best_score:
                best_score = score
                ckpt_meta["best_score"] = best_score
                export_best(model, run_dir, score, epoch)

        t0 = time.time()
        skip = resume_skip if epoch == start_epoch else 0
        if skip:
            loader.skip_next_batches(skip)
            logger.info("resuming epoch %d at batch %d (mid-epoch checkpoint)",
                        epoch, skip)
        pending = None   # (step, metrics): logged one step late, so the host
        # does not wait for the step it has just queued
        for bi, (frames, sizes, gmeans) in enumerate(
                device_prefetch(loader, to_device, stream=copy_stream)):
            if cfg.max_steps_per_epoch and bi + skip >= cfg.max_steps_per_epoch:
                break
            state, metrics = step_fn(state, frames, sizes, gmeans,
                                     step_generator(cfg.seed, global_step))
            global_step += 1
            if not mem_reported:
                mem_reported = True
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                    gib = 1024 ** 3
                    in_use = torch.cuda.memory_allocated(device)
                    logger.info("device memory after step %d: %.2f GiB in use, "
                                "%.2f GiB peak", global_step, in_use / gib,
                                torch.cuda.max_memory_allocated(device) / gib)
                    writer.scalar("Memory/bytes_in_use", float(in_use), global_step)
            if pending is not None:
                log_pending(pending)
            pending = (global_step, metrics)
            if cfg.checkpoint_every_steps and global_step % cfg.checkpoint_every_steps == 0:
                save_checkpoint(state, run_dir, epoch, meta=ckpt_meta)
            if preempt["flag"]:
                log_pending(pending)
                save_checkpoint(state, run_dir, epoch, meta=ckpt_meta)
                logger.info("preemption signal: checkpoint saved at step %d "
                            "(epoch %d); resume with --load_checkpoint",
                            global_step, epoch)
                return finish(preempted=True)
        if pending is not None:
            log_pending(pending)
        logger.info("epoch %d done in %.1fs (loss %s)", epoch, time.time() - t0,
                    last_loss)

    # the epoch-top saves never hold the last epoch's training: epoch =
    # num_epochs marks every epoch trained, so a same-config resume is a no-op
    save_checkpoint(state, run_dir, cfg.num_epochs, meta=ckpt_meta)
    return finish()
