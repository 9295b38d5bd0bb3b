"""The TimeT training driver.

Counterpart of ``timetuning_tpu/core/train.py`` (reference ``time_tuning()``
and its launcher, time_tuning.py:508-717): the model, data and optimizer
assembly, the epoch loop with a checkpoint at the top of every epoch, the
Pascal VOC clustering eval every ``eval_every`` epochs with the best model
exported, and the per-step loss log.

One process a device (the card unless ``device="cpu"``): the uint8 host
batch is copied from pinned memory on a side stream while the previous step
runs, then augmented (data/transforms.apply_augment) and stepped
(core/timet) on the device. Every step's randomness (the augmentation's
draws and the queue's choice) comes from ``step_generator(seed, step,
rank)``, so a resumed run draws what the uninterrupted run drew at the same
step, and no generator state is checkpointed.

Data parallelism: when the caller has initialized a ``torch.distributed``
group of more than one process (``cli/train --multihost`` under
``torchrun``), each process is a rank of the data axis. Its loader yields
its ``rank::world`` share of the videos (``batch_size`` clips a rank), the
step averages over the group (core/timet), rank 0 alone chooses the run
directory, writes the checkpoint, logs and evaluates, and every rank
resumes from the same files. ``zero1`` splits the optimizer state over the
ranks.

Tensor parallelism (``tensor_parallel`` = tp > 1, JAX core/train.py:354-379,
413-424, 985-996): the ranks form a (data, model) mesh of dp = world / tp
rows (parallel/tp); the ranks of one model group load the same share of the
videos (``batch_size x tp`` clips: the global batch is ``batch_size`` a
process, as JAX's per-host batch) and draw the same augmentation, each
holds its Megatron slices of the student, the teacher and the AdamW
moments, and the step is the single-device step on the global batch with
one global feature FIFO of ``queue_size`` rows (rounded down to a multiple
of dp). The backbone runs plain attention. The checkpoint holds the whole
layout (gathered, rank 0 writes; meta ``tensor_parallel``), and rank 0
evaluates and exports on the gathered parameters. ZeRO-1 is refused with
it, as in JAX.
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
    saved_zero1_padding,
)
from timetuning_tpu_torch.core.optimizer import swav_optimizer, swav_optimizer_zero1
from timetuning_tpu_torch.core.timet import (
    TimeT,
    TimeTConfig,
    init_state,
    make_train_step,
    _graft,
    replicated_tensors,
    state_tensors,
    step_metrics,
)
from timetuning_tpu_torch.data.transforms import (
    IMAGENET_STD,
    AugmentConfig,
    AugmentParams,
    apply_augment,
    draw_augment_params,
    eval_preprocess_batch,
)
from timetuning_tpu_torch.data.loader import host_batch_to_device
from timetuning_tpu_torch.obs.logging import MetricsWriter, dump_config, make_file_logger
from timetuning_tpu_torch.obs.profiling import annotate
from timetuning_tpu_torch.parallel import mesh
from timetuning_tpu_torch.runtime import CapturedCall, resolve_device


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
    num_devices: int | None = None          # the ranks of the process group
    streaming_eval: bool = False            # bounded-memory dataset-wise eval
    checkpoint_every_steps: int | None = None  # mid-epoch periodic saves
    handle_preemption: bool = True          # SIGTERM -> save + clean exit
    # optimizer state and EMA over the trainable subtree only; False keeps
    # state for the full tree (checkpoints load into either)
    opt_over_trainable: bool = True
    log_histograms: bool = False
    zero1: bool = False                     # optimizer state split over ranks
    pack_path: str | None = None            # decode-once packed clip cache
    fast_decode: bool = False
    tensor_parallel: int = 1                # the model axis of a (data, model) mesh
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


def step_generator(seed: int, step: int, rank: int = 0) -> torch.Generator:
    """The host generator of global step ``step`` on data rank ``rank``: a
    pure function of (seed, step, rank), forked from the model's init stream
    by a constant. The ranks draw apart (their augmentations and queue
    choices differ, as JAX folds the axis index into the step's key); rank
    0 draws what one process draws."""
    entropy = [seed, 0x57E9, step] + ([rank] if rank else [])
    s = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(s))


def queue_loss_copy(loss: torch.Tensor):
    """Step n's loss on its way to the host, queued right after step n:
    ``(value, ready)``, a copy into fresh pinned memory and an event
    recorded behind it on the loss's stream. Waiting on ``ready`` waits for
    step n alone, not for the steps queued after it, so the card runs on
    while the host reads. A CPU loss is ``(loss, None)``."""
    if not loss.is_cuda:
        return loss, None
    value = torch.empty(loss.shape, dtype=loss.dtype, pin_memory=True)
    value.copy_(loss, non_blocking=True)
    # a blocking event: the host thread sleeps through the wait, leaving
    # its core to the loader's threads
    ready = torch.cuda.Event(blocking=True)
    ready.record(torch.cuda.current_stream(loss.device))
    return value, ready


def read_queued_loss(value: torch.Tensor, ready) -> float:
    """The float of ``queue_loss_copy``'s value, once its copy is done."""
    if ready is not None:
        ready.synchronize()
    return float(value)


def make_full_step(model: TimeT, tcfg: TimeTConfig, opt, aug_cfg: AugmentConfig,
                   trainable_mask=None, opt_over_trainable: bool | None = None,
                   mesh=None, graphed: bool = True):
    """uint8 batch -> augment -> TimeT step on the model's device. Returns
    ``full(state, frames_u8, src_sizes, gray_means, generator)``: the
    augmentation's values are drawn from ``generator`` first, then the
    queue's choice. ``mesh``: the (data, model) mesh of a TP run
    (parallel/tp.make_tp_train_step).

    The JAX package's ``full`` is one jitted program; here the device work
    (the augmentation and the step's ``device_step``) is one CUDA graph a
    (batch shape, queue ready) on the card (runtime.CapturedCall), keyed
    also on the addresses of the state's tensors, which it updates in place.
    The host draws, the queue's choice and the step's scheduled scalars
    (learning rates, weight decay, EMA momentum) go into one table, copied
    to the device before the replay. The first call of a key runs eagerly
    (a real step), the next captures and replays. A step over a process
    group or on CPU tensors stays eager (``CapturedCall``'s rule).
    ``graphed=False`` runs the same device work eagerly: the graphs'
    reference."""
    if opt_over_trainable is None:
        opt_over_trainable = trainable_mask is not None
    if mesh is not None:
        from timetuning_tpu_torch.parallel.tp import make_tp_train_step

        base_step, _ = make_tp_train_step(model, tcfg, opt, mesh,
                                          trainable_mask=trainable_mask,
                                          opt_over_trainable=opt_over_trainable)
    else:
        base_step = make_train_step(model, tcfg, opt, trainable_mask=trainable_mask,
                                    opt_over_trainable=opt_over_trainable)

    def device_full(frames_u8, src_sizes, gray_means, table, state, queue_ready,
                    n_aug: int, n_store: int):
        """The device work of one step; ``table`` holds the augmentation's
        draws, the queue's rows (exact in f32: fewer than 2^24) and the
        step's scalars."""
        B, F = frames_u8.shape[:2]
        params = AugmentParams(table[:n_aug].view(B, -1), F)
        clips, _ = apply_augment(frames_u8, params, aug_cfg, src_sizes, gray_means)
        idx = table[n_aug:n_aug + n_store].long() if n_store else None
        return base_step.device_step(state, clips, idx, table[n_aug + n_store:],
                                     queue_ready)

    program = CapturedCall(device_full, group=base_step.group)

    def full(state, frames_u8, src_sizes, gray_means, generator):
        B, F = frames_u8.shape[:2]
        dev = frames_u8.device
        params = draw_augment_params(generator, B, F, aug_cfg)
        p = base_step.plan(state, B, generator)
        parts = [params.table.reshape(-1)]
        if p.idx is not None:
            parts.append(p.idx.float())
        table = host_batch_to_device(torch.cat(parts + [torch.tensor(p.scalars)]).numpy(),
                                     dev)
        if src_sizes is not None:
            src_sizes = torch.as_tensor(src_sizes).to(dev)
        if gray_means is not None:
            gray_means = torch.as_tensor(gray_means).to(dev)
        args = (frames_u8, src_sizes, gray_means, table, state, p.queue_ready,
                params.table.numel(), p.n_store)
        if graphed:
            key = (p.queue_ready, tuple(t.data_ptr() for t in state_tensors(state).values()))
            scalars = program(*args, key=key)
        else:
            scalars = device_full(*args)
        base_step.commit(state, p)
        # into memory the next replay does not write: run_training reads step
        # n's loss after it has launched step n + 1
        return state, step_metrics([s.clone() for s in scalars], p)

    return full


def make_eval_feature_fn(model: TimeT, input_resolution: int, graphed: bool = True):
    """The in-training eval's feature function (the JAX driver's
    ``feature_fn_jit``, core/train.py:838-856): uint8 frames [N, H, W, 3] ->
    (patch features [N, P, D], last attention or None) on the model's
    device, no grad. The frames are resized and normalised in the model's
    compute dtype (the preprocess kernel for bf16 on the card), which is
    where the JAX model rounds its f32 input. On the card a CUDA graph a
    (batch shape, want_attention) for the whole run (runtime.CapturedCall),
    reading the live parameters, which the optimizer updates in place; the
    outputs are the caller's own (cloned out of the graph's memory)."""
    device = model.prototypes.device
    dtype = getattr(getattr(model.feature_extractor.backbone, "config", None),
                    "dtype", torch.float32)

    def features(x, want_attention: bool):
        x = eval_preprocess_batch(x, out_size=input_resolution, std=IMAGENET_STD,
                                  compute_dtype=dtype)
        return model(x, use_head=False, want_attention=want_attention)

    program = CapturedCall(features)

    @torch.no_grad()
    def feature_fn(frames, want_attention: bool = False):
        x = torch.as_tensor(np.asarray(frames) if not torch.is_tensor(frames)
                            else frames).to(device)
        if not graphed:
            return features(x, bool(want_attention))
        out = program(x, bool(want_attention), key=bool(want_attention))
        return tuple(None if t is None else t.clone() for t in out)

    return feature_fn


def make_diagnostics_scores_fn(model: TimeT, input_resolution: int,
                               graphed: bool = True):
    """(normalised images, prototype scores) of uint8 frames, for the
    training diagnostics: f32 preprocessing as the JAX driver's. A CUDA graph
    a batch shape on the card, as ``make_eval_feature_fn``; ``graphed=False``
    runs it eagerly, the graph's reference."""
    device = model.prototypes.device

    def scores(x):
        x = eval_preprocess_batch(x, out_size=input_resolution, std=IMAGENET_STD)
        feats, _ = model(x, use_head=True)
        return x, model.similarity(feats)

    program = CapturedCall(scores)

    @torch.no_grad()
    def scores_fn(frames_u8):
        x = torch.as_tensor(np.asarray(frames_u8) if not torch.is_tensor(frames_u8)
                            else frames_u8).to(device)
        if not graphed:
            return scores(x)
        return tuple(t.clone() for t in program(x))

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


def _check_parallel(cfg: TrainingConfig, world: int) -> None:
    tp = cfg.tensor_parallel
    if tp < 1:
        raise ValueError(f"tensor_parallel must be >= 1, got {tp}")
    if tp > 1:
        if world % tp:
            raise ValueError(f"tensor_parallel={tp} must divide the {world} devices")
        dp = world // tp
        # batch_size is a process's (JAX's per-host batch): the global batch
        # batch_size x processes splits over the data axis
        if (cfg.batch_size * world) % dp:
            raise ValueError(
                f"global batch {cfg.batch_size} x {world} process(es) must divide "
                f"over the data axis (dp={dp} at tensor_parallel={tp})")
        if cfg.zero1:
            raise ValueError(
                "zero1 and tensor_parallel are mutually exclusive (ZeRO-1 shards "
                "the flat optimizer vector over the data axis; under TP the "
                "moments already shard over the model axis)")
    if cfg.num_devices is not None and cfg.num_devices != world:
        # one process a device: a silent mismatch would desynchronise
        # world_size from the group (wrong Sinkhorn marginals, queue shapes)
        raise ValueError(
            f"num_devices={cfg.num_devices} but {world} process(es) run: the "
            "port runs one process a device, so start num_devices ranks "
            "(torchrun --nproc_per_node N ... --multihost true)")


def _broadcast_str(s: str | None, device, group, max_len: int = 512) -> str:
    """Agree on a string across the ranks (rank 0's value wins)."""
    buf = torch.zeros(max_len, dtype=torch.uint8)
    if s is not None:
        b = s.encode()
        if len(b) > max_len:
            raise ValueError(f"string too long to broadcast: {s!r}")
        buf[:len(b)] = torch.frombuffer(bytearray(b), dtype=torch.uint8)
    buf = buf.to(device)
    mesh.broadcast_tensors([buf], group)
    return bytes(buf.cpu().numpy()).rstrip(b"\0").decode()


def _barrier(device, group) -> None:
    mesh.all_reduce_sum(torch.zeros(1, device=device), group)


class _NoWriter:
    """The metrics writer of ranks other than 0: they log nothing."""

    def scalar(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def run_training(cfg: TrainingConfig) -> dict[str, Any]:
    world = mesh.data_world_size()
    rank = mesh.data_rank()
    # every rank: the run dir, the barriers, the checkpoint's writer
    group = mesh.data_group(mesh.DATA_AXIS) if world > 1 else None
    _check_parallel(cfg, world)
    tp = cfg.tensor_parallel
    dp = world // tp
    device = resolve_device(cfg.device)
    from timetuning_tpu_torch.data.datasets import SamplingMode
    from timetuning_tpu_torch.data.loader import device_prefetch, make_loader

    run_dir = None
    if rank == 0:
        run_dir = (find_last_run_directory(cfg.log_dir) if cfg.load_checkpoint
                   else None) or make_run_directory(cfg.log_dir)
    if group is not None:
        # the run dir is timestamped and resume scans the file system: every
        # rank takes rank 0's, or the ranks would save and resume apart
        run_dir = _broadcast_str(run_dir, device, group)
    if rank == 0:
        dump_config(dataclasses.asdict(cfg), run_dir)
        writer = MetricsWriter(run_dir, use_tensorboard=cfg.use_tensorboard)
        logger = make_file_logger("train", run_dir)
    else:
        import logging

        writer, logger = _NoWriter(), logging.getLogger(f"train.rank{rank}")

    model, pretrained, spatial_res = build_model(cfg, device)
    tp_mesh = None
    data_index = rank
    if tp > 1:
        from timetuning_tpu_torch.parallel import tp as tpm

        bcfg = getattr(model.feature_extractor.backbone, "config", None)
        if bcfg is not None:
            tpm.validate_tp_geometry(bcfg, tp)
        tpm.force_xla_attention(model)
        if pretrained is not None:
            _graft(model, pretrained)
            pretrained = None
        # the whole weights start as rank 0's; then each rank keeps its slices
        mesh.broadcast_tensors([p for _, p in model.named_parameters()], group)
        tp_mesh = tpm.make_dp_tp_mesh(dp, tp)
        tpm.shard_params(tp_mesh, model)
        data_index = tp_mesh.outer_index

    if cfg.pack_path:
        if rank == 0 and not (os.path.exists(cfg.pack_path)
                              and os.path.exists(cfg.pack_path + ".index.json")):
            from timetuning_tpu_torch.native import build_clip_pack

            plain = make_loader(cfg.dataset, num_clip_frames=cfg.num_frames,
                                batch_size=cfg.batch_size, root=cfg.data_root,
                                decode_size=cfg.decode_size,
                                fast_decode=cfg.fast_decode)
            t0 = time.time()
            build_clip_pack(plain.dataset, cfg.pack_path)
            logger.info("clip pack built at %s in %.1fs", cfg.pack_path,
                        time.time() - t0)
        if group is not None:
            # every rank needs the pack before opening it; joining may not
            # depend on the existence probe, or a rank arriving after the
            # build would pair rank 0's barrier with its first step's
            # collective
            _barrier(device, group)
    loader = make_loader(
        cfg.dataset, num_clip_frames=cfg.num_frames, batch_size=cfg.batch_size * tp,
        regular_step=cfg.regular_step, sampling_mode=SamplingMode.UNIFORM,
        shuffle=True, num_workers=cfg.num_workers, root=cfg.data_root,
        decode_size=cfg.decode_size, pack_path=cfg.pack_path,
        fast_decode=cfg.fast_decode, seed=cfg.seed,
        # equal per-rank counts: another count would leave one rank in a
        # collective that the others never join; the ranks of a model group
        # load the same share
        world_size=dp, rank=data_index,
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
        # the reference's per-rank queue of queue_size / world rows
        # (time_tuning.py:617-618); under TP one global FIFO, its rows a
        # multiple of dp
        queue_size=(cfg.queue_size // dp) * dp if tp > 1 else cfg.queue_size // world,
        mask_features=cfg.use_mask,
        axis_name=mesh.DATA_AXIS if group is not None and tp == 1 else None,
        world_size=1 if tp > 1 else world,
        ema_start=cfg.ema_decay, num_epochs=cfg.num_epochs,
        steps_per_epoch=steps_per_epoch, spatial_resolution=spatial_res,
        frozen_trunk_blocks=frozen_trunk_split(cfg.unfreeze_layers,
                                               model.feature_extractor.backbone),
    )
    if cfg.use_queue and tcfg.queue_size <= 0:
        raise ValueError(f"--queue_size {cfg.queue_size} gives the feature queue "
                         f"no rows on each of the {world} rank(s)")

    zero1 = cfg.zero1 and group is not None
    if cfg.zero1 and not zero1:
        logger.warning("zero1 requested but disabled: it needs more than one "
                       "rank (found %d); a ZeRO-1 checkpoint still resumes here, "
                       "converted to this run's layout", world)
    if zero1 and not cfg.opt_over_trainable:
        raise ValueError("zero1=True requires opt_over_trainable=True")
    opt_kwargs = dict(
        lr=cfg.head_lr, backbone_lr=cfg.head_lr / 10,
        num_epochs=cfg.num_epochs, steps_per_epoch=steps_per_epoch,
        unfreeze_layers=cfg.unfreeze_layers,
        use_cosine_lr=cfg.lr_scheduler == "CosineAnnealingLR")
    if zero1:
        opt, trainable_mask, _ = swav_optimizer_zero1(
            model, world_size=world, rank=rank, **opt_kwargs)
    else:
        opt, trainable_mask = swav_optimizer(
            model, opt_over_trainable=cfg.opt_over_trainable, **opt_kwargs)
    opt_layout = "zero1" if zero1 else (
        "trainable-subtree" if cfg.opt_over_trainable else "full-tree")
    state = init_state(model, tcfg, opt, pretrained_params=pretrained,
                       trainable_mask=trainable_mask if cfg.opt_over_trainable else None,
                       mesh=tp_mesh)
    if group is not None:
        # the replicated state starts as rank 0's on every rank
        mesh.broadcast_tensors(replicated_tensors(state).values(), group)
    # the queue's partition: the ranks' FIFOs, or one global FIFO under TP
    q_world, q_rank = (1, 0) if tp > 1 else (world, rank)
    start_epoch = 0
    resume_skip = 0
    best_score = -1.0
    if cfg.load_checkpoint:
        state, start_epoch = load_checkpoint(run_dir, state)
        meta = load_checkpoint_meta(run_dir) or {}
        if meta.get("opt_layout", opt_layout) != opt_layout:
            logger.info("checkpoint used the %s optimizer layout (world %s, ZeRO-1 "
                        "padding %s): converted to this run's %s layout",
                        meta["opt_layout"], meta.get("world_size"),
                        saved_zero1_padding(run_dir), opt_layout)
        # a mid-epoch checkpoint (checkpoint_every_steps, preemption) holds
        # step > start_epoch * steps_per_epoch: skip the batches of the epoch
        # it already trained (the shuffle is keyed by (seed, epoch)), unless
        # the batching changed since the save
        if meta.get("steps_per_epoch") == steps_per_epoch:
            resume_skip = min(max(0, state.step - start_epoch * steps_per_epoch),
                              steps_per_epoch)
        if "best_score" in meta:
            best_score = float(meta["best_score"])
        if cfg.use_queue and state.queue is not None:
            # the queue is FIFO state partitioned (world, rows a rank): a
            # changed partition scrambles which rows queue_fill marks valid,
            # even where the total row count stays, so it is reset and
            # refills (JAX core/train.py:775-800)
            rows = tcfg.queue_size
            repartitioned = (meta.get("queue_rows_per_device", rows) != rows
                             or meta.get("world_size", q_world) != q_world)
            if state.queue.shape[0] != rows * q_world or repartitioned:
                logger.warning(
                    "feature queue reset on restore: checkpoint has %s, this run "
                    "needs %d rank(s) x %d rows; it refills during training",
                    f"{meta.get('world_size')} rank(s) x "
                    f"{meta.get('queue_rows_per_device')} rows" if meta
                    else f"{state.queue.shape[0]} rows", q_world, rows)
                state.queue = torch.zeros(rows, state.queue.shape[1], device=device)
                state.queue_fill = 0
            else:
                state.queue = state.queue[q_rank * rows:(q_rank + 1) * rows].clone()

    aug_cfg = AugmentConfig(out_size=cfg.input_resolution)
    step_fn = make_full_step(model, tcfg, opt, aug_cfg, trainable_mask=trainable_mask,
                             opt_over_trainable=cfg.opt_over_trainable, mesh=tp_mesh)

    evaluator_factory = None
    eval_res = default_eval_resolution(cfg)
    # under TP rank 0 evaluates and exports a whole model that takes the
    # gathered parameters before each eval
    eval_model = model
    if cfg.pascal_root and rank == 0:
        from timetuning_tpu_torch.data.pascal import pascal_loader
        from timetuning_tpu_torch.eval.evaluator import Evaluator

        eval_loader = pascal_loader(60, cfg.pascal_root, "val", eval_res,
                                    cfg.input_resolution)
        if tp > 1:
            eval_model = build_model(cfg, device)[0]
        feature_fn = make_eval_feature_fn(eval_model, cfg.input_resolution)

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
        "world_size": q_world, "queue_rows_per_device": tcfg.queue_size,
        "tensor_parallel": tp, "opt_layout": opt_layout,
        "best_score": best_score, "steps_per_epoch": steps_per_epoch,
    }

    def log_pending(pending, next_ready=None):
        """Log a pending step. ``next_ready``: the event of the step queued
        behind it; still pending when the read ends, it shows that the card
        had work while the host read (``queued`` on ``train.loss_read``)."""
        nonlocal last_loss
        pstep, pmetrics, value, ready = pending
        with annotate("train.log", step=pstep):
            with annotate("train.loss_read") as span:
                last_loss = read_queued_loss(value, ready)
                if span is not None:
                    span.attrs["queued"] = next_ready is not None and not next_ready.query()
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
        with annotate("train.epoch", epoch=epoch):
            save_checkpoint(state, run_dir, epoch, meta=ckpt_meta, group=group)
            loader.set_epoch(epoch)
            # a resumed mid-epoch checkpoint skips this epoch's eval: the
            # uninterrupted run already scored it before the interruption
            eval_epoch = (cfg.pascal_root and epoch % cfg.eval_every == 0
                          and not (epoch == start_epoch and resume_skip > 0))
            do_eval = evaluator_factory is not None and eval_epoch
            if eval_epoch and tp > 1:
                # a collective over the model axis, on every rank
                from timetuning_tpu_torch.parallel.tp import gather_global_params

                full = gather_global_params(model)
                if do_eval:
                    eval_model.load_state_dict(full)
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
                        diag_scores_fn = make_diagnostics_scores_fn(eval_model,
                                                                    cfg.input_resolution)
                    log_training_diagnostics(diag_scores_fn, eval_loader, writer,
                                             run_dir, epoch, cfg, spatial_res)
                if score > best_score:
                    best_score = score
                    ckpt_meta["best_score"] = best_score
                    export_best(eval_model, run_dir, score, epoch)

            t0 = time.time()
            skip = resume_skip if epoch == start_epoch else 0
            if skip:
                loader.skip_next_batches(skip)
                logger.info("resuming epoch %d at batch %d (mid-epoch checkpoint)",
                            epoch, skip)
            # (step, metrics, loss copy, its event): logged one step late,
            # after the next step is queued; the loss's copy is queued before
            # that step, so the read waits for its own step alone
            pending = None
            for bi, (frames, sizes, gmeans) in enumerate(
                    device_prefetch(loader, to_device, stream=copy_stream)):
                if cfg.max_steps_per_epoch and bi + skip >= cfg.max_steps_per_epoch:
                    break
                with annotate("train.step", step=global_step):
                    state, metrics = step_fn(
                        state, frames, sizes, gmeans,
                        step_generator(cfg.seed, global_step, data_index))
                global_step += 1
                current = (global_step, metrics, *queue_loss_copy(metrics["loss"]))
                if not mem_reported:
                    mem_reported = True
                    if device.type == "cuda" and rank == 0:
                        torch.cuda.synchronize(device)
                        gib = 1024 ** 3
                        in_use = torch.cuda.memory_allocated(device)
                        logger.info("device memory after step %d: %.2f GiB in use, "
                                    "%.2f GiB peak", global_step, in_use / gib,
                                    torch.cuda.max_memory_allocated(device) / gib)
                        writer.scalar("Memory/bytes_in_use", float(in_use), global_step)
                if pending is not None:
                    log_pending(pending, next_ready=current[3])
                pending = current
                if cfg.checkpoint_every_steps and global_step % cfg.checkpoint_every_steps == 0:
                    save_checkpoint(state, run_dir, epoch, meta=ckpt_meta, group=group)
                # over a group the ranks agree on the flag every 20 steps (the
                # batch index is aligned: equal per-rank counts), so all stop at
                # one step: SIGTERM may reach one rank first, and the save is a
                # collective
                preempt_now = preempt["flag"]
                if group is not None:
                    preempt_now = bi % 20 == 0 and mesh.all_reduce_sum(
                        torch.tensor([float(preempt["flag"])], device=device),
                        group).item() > 0
                if preempt_now:
                    log_pending(pending)
                    save_checkpoint(state, run_dir, epoch, meta=ckpt_meta, group=group)
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
    save_checkpoint(state, run_dir, cfg.num_epochs, meta=ckpt_meta, group=group)
    return finish()
