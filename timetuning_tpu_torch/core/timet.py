"""TimeT, the self-supervised time-tuning core: model, state and train step.

Counterpart of ``timetuning_tpu/core/timet.py`` (reference
time_tuning.py:80-302, 379-429, 508-669). One call

    state, metrics = step_fn(state, clip, generator)

takes one optimisation step. The JAX step is a pure function over a state
pytree; here the student lives in the ``TimeT`` module and is updated in
place, and ``TrainState`` carries what is not a module parameter: the
optimizer, the EMA teacher, the feature queue, the counters. ``step_fn``
returns the state it was given.

What a step computes is the JAX step's, pass for pass:
  * only the three slices of the reference's three full-clip passes that the
    loss consumes: backbone(all frames, no grad) for the propagation,
    teacher(first frame) for the Sinkhorn targets, student-with-head(last
    frame) for the scores;
  * with ``frozen_trunk_blocks=k`` the blocks [0, k) run once over all
    frames, without grad, and the three tails fan out of that trunk: frozen
    blocks are identical in student and teacher for the whole run;
  * the EMA keeps the reference's direction ``teacher = teacher * (1 - m) +
    student * m`` with m going 0.995 -> 1.0 (time_tuning.py:113-115).

Data parallelism (``TimeTConfig.axis_name``): one process per device, the
axis being the default ``torch.distributed`` group (parallel/mesh). Each
rank steps on its slice of the global batch with the same replicated
student, teacher, prototypes and (without ZeRO-1) optimizer state, and its
own feature queue, filled from its own batch: the JAX step shard_mapped
over ``data`` (``timetuning_tpu/core/timet.py:253-287``). The Sinkhorn
statistics are summed over the group (kernel 11's cross-rank form on the
card), and the trainable gradients and the loss are averaged by one
all-reduce of a flat vector, so every rank applies the same update and the
replicated state stays bit-identical. With ZeRO-1 (``Zero1Optimizer``) a
rank updates only its chunk of the flat trainable vector and the full
update is rebuilt by the all-reduce of the zero-scattered chunks.

The no-grad passes run the model's own attention implementation (in bf16 on
the card: the hand-written block kernels). The differentiated pass of an
``attn_impl="auto"`` model runs plain attention by default
(``TimeTConfig.grad_attn_impl="xla"``), per call, on the same module; with
``grad_attn_impl=None`` or ``"auto"`` it runs the model's own
implementation, the block kernels included, whose backward is the JAX
package's (the VJP of the plain composition, ops/fused_block). A forced
implementation is kept on the grad path too.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from timetuning_tpu_torch.core.optimizer import SwavOptimizer, Zero1Optimizer
from timetuning_tpu_torch.core.schedules import cosine_scheduler, schedule_at
from timetuning_tpu_torch.models.extractor import FeatureExtractor, apply_attention_mask
from timetuning_tpu_torch.ops.propagation import propagate_labels_batch
from timetuning_tpu_torch.ops.sinkhorn import sinkhorn_assignment
from timetuning_tpu_torch.parallel.mesh import (
    all_reduce_mean,
    all_reduce_sum,
    data_group,
    data_world_size,
)

_EPS = 1e-12


def _l2norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + _EPS)


def _proto_init(shape, generator: torch.Generator) -> torch.Tensor:
    """randn, then L2-normalised rows (reference time_tuning.py:90-93)."""
    return _l2norm(torch.randn(shape, generator=generator))


class TimeT(nn.Module):
    """FeatureExtractor + prototype bank (reference ``TimeT``,
    time_tuning.py:80-93); ``forward`` is ``TimeT.forward(train=False)``
    (:186-196) and returns (features, attentions). The parameter names,
    ``feature_extractor.{backbone, head}.*`` and ``prototypes``, are those of
    the published TimeT.pth state dict."""

    def __init__(self, feature_extractor: FeatureExtractor,
                 n_prototypes: int = 200, prototype_dim: int | None = None):
        super().__init__()
        if prototype_dim is None:
            if not feature_extractor.head_dims:
                raise ValueError(
                    "prototype_dim is required when the extractor has no head")
            prototype_dim = feature_extractor.head_dims[-1]
        self.feature_extractor = feature_extractor
        self.prototypes = nn.Parameter(torch.zeros(n_prototypes, prototype_dim))

    def init_weights(self, generator: torch.Generator) -> "TimeT":
        """Seeded random weights for the backbone, the head and the
        prototypes (drawn on the CPU, whatever the module's device)."""
        fe = self.feature_extractor
        fe.backbone.init_weights(generator)
        if fe.head_dims:
            fe.head.init_weights(generator)
        with torch.no_grad():
            self.prototypes.copy_(_proto_init(self.prototypes.shape, generator))
        return self

    def forward(self, x, use_head: bool = True, want_attention: bool = False,
                start_block: int = 0, attn_impl: str | None = None):
        return self.feature_extractor(
            x, use_head=use_head, want_attention=want_attention,
            start_block=start_block, attn_impl=attn_impl)

    def similarity(self, feats: torch.Tensor,
                   prototypes: torch.Tensor | None = None) -> torch.Tensor:
        """Cosine scores against the prototype bank (reference
        ``get_feature_prototype_similarity``, time_tuning.py:130-141): feats
        [..., D] -> [..., K] f32. The prototypes are kept unit-norm by the
        renormalisation after each step, so a plain product is the cosine.
        ``prototypes`` stands in for the module's own (the teacher's)."""
        protos = self.prototypes if prototypes is None else prototypes
        return torch.matmul(_l2norm(feats).float(), protos.float().t())


@dataclasses.dataclass(frozen=True)
class TimeTConfig:
    """Training hyperparameters (reference argparse surface,
    time_tuning.py:673-714, with the effective loss defaults of get_loss).
    The fields and defaults are the JAX ``TimeTConfig``'s."""

    n_prototypes: int = 200
    epsilon: float = 0.05
    sinkhorn_iterations: int = 10      # get_loss default wins over the CLI flag
    n_last_frames: int = 7             # get_loss default (time_tuning.py:224)
    size_mask_neighborhood: int = 6
    topk: int = 5
    score_temperature: float = 0.1
    use_teacher: bool = True
    use_queue: bool = False
    queue_size: int = 16384            # rows of this process's FIFO
    mask_features: bool = False
    axis_name: str | None = None       # data axis: the default process group
    world_size: int = 1                # ranks on it; the Sinkhorn marginal
    ema_start: float = 0.995
    ema_end: float = 1.0
    num_epochs: int = 100
    steps_per_epoch: int = 1000
    spatial_resolution: int = 14
    # Blocks [0, frozen_trunk_blocks) are computed once per step over all
    # frames and shared by the no-grad, teacher and student passes; valid
    # when only a suffix of the backbone trains (the reference default:
    # blocks 10 and 11, time_tuning.py:574). None runs three full passes.
    frozen_trunk_blocks: int | None = None
    # Attention implementation of the differentiated pass when the model's
    # own is "auto"; None keeps the model's everywhere.
    grad_attn_impl: str | None = "xla"
    moe_aux_weight: float = 0.0        # mixture-of-experts: not ported yet

MOE_ITEM = "ROADMAP.md queue 1 item 11b, 'MoE'"


@dataclasses.dataclass
class TrainState:
    """What a step carries besides the student's parameters (which live in
    ``model``). ``teacher`` maps parameter names to the EMA teacher's
    tensors; a name it does not hold is shared with the student (the frozen
    leaves, when the optimizer runs over the trainable subtree only).
    ``queue_fill`` and ``step`` are host integers."""

    model: TimeT
    opt: SwavOptimizer | Zero1Optimizer
    teacher: dict[str, torch.Tensor] | None
    queue: torch.Tensor | None         # [queue_size, D] or None
    queue_fill: int = 0
    step: int = 0


def _graft(model: TimeT, pretrained: Mapping[str, torch.Tensor]) -> None:
    """Overlay imported weights onto the model's (keys present in
    ``pretrained`` win; names must exist and shapes must match)."""
    own = dict(model.named_parameters())
    with torch.no_grad():
        for k, v in pretrained.items():
            if k not in own:
                raise KeyError(f"pretrained key {k} not in model tree")
            if own[k].shape != v.shape:
                raise ValueError(f"shape mismatch for {k}: "
                                 f"{tuple(own[k].shape)} vs {tuple(v.shape)}")
            own[k].copy_(v)


def init_state(model: TimeT, cfg: TimeTConfig, opt: SwavOptimizer,
               pretrained_params: Mapping[str, torch.Tensor] | None = None,
               trainable_mask: Mapping[str, bool] | None = None) -> TrainState:
    """The initial state around an initialised ``model`` (optionally grafting
    imported weights first): teacher copy, queue, counters. With
    ``trainable_mask`` (from ``swav_optimizer(..., opt_over_trainable=True)``)
    the teacher copies the trainable leaves only and shares the frozen ones
    with the student, which never change."""
    if pretrained_params is not None:
        _graft(model, pretrained_params)
    teacher = None
    if cfg.use_teacher:
        teacher = {n: p.detach().clone() for n, p in model.named_parameters()
                   if trainable_mask is None or trainable_mask[n]}
    queue = None
    if cfg.use_queue:
        queue = torch.zeros(cfg.queue_size, model.prototypes.shape[-1],
                            dtype=torch.float32, device=model.prototypes.device)
    return TrainState(model=model, opt=opt, teacher=teacher, queue=queue)


def state_partition_specs(state: TrainState) -> dict[str, str]:
    """Which parts of the state each rank holds whole ("replicated": equal on
    every rank) and which are its own ("per_rank"): the feature queue (the
    rank's FIFO, filled from its batch) and, with ZeRO-1, the optimizer's
    moments (the rank's chunk). The counterpart of JAX's PartitionSpecs
    (``P()`` / ``P('data')``)."""
    return {
        "params": "replicated",
        "teacher": "replicated",
        "queue": "per_rank",
        "queue_fill": "replicated",
        "step": "replicated",
        "opt": "per_rank" if isinstance(state.opt, Zero1Optimizer) else "replicated",
    }


def replicated_tensors(state: TrainState) -> dict[str, torch.Tensor]:
    """Every tensor of the state that the ranks hold equal: the parameters,
    the teacher, and the AdamW moments unless ZeRO-1 splits them."""
    out = {f"params.{n}": p for n, p in state.model.named_parameters()}
    for n, t in (state.teacher or {}).items():
        out[f"teacher.{n}"] = t
    if state_partition_specs(state)["opt"] == "replicated":
        for n, p in state.opt.named_params.items():
            for k, v in state.opt.adamw.state.get(p, {}).items():
                if torch.is_tensor(v) and v.dim():
                    out[f"opt.{n}.{k}"] = v
    return out


def queue_store_indices(n: int, n_store: int,
                        generator: torch.Generator | None) -> torch.Tensor:
    """Which of the step's ``n`` first-frame features enter the queue: the
    first ``n_store`` of a seeded random permutation (reference
    time_tuning.py:250-258)."""
    return torch.randperm(n, generator=generator)[:n_store]


def _check_trunk_is_frozen(split: int, trainable_mask: Mapping[str, bool]) -> None:
    """The shared trunk is only valid when every leaf below the split is
    frozen: a trainable trunk leaf would get no gradient (the trunk runs
    without grad) while weight decay kept shrinking it, in silence."""
    for name, trainable in trainable_mask.items():
        if not trainable or "backbone" not in name.split("."):
            continue
        m = re.search(r"blocks\.(\d+)\.", name)
        # the embedding leaves (patch_embed, pos_embed, cls_token) run inside
        # the trunk; of the non-block leaves only the final norm is the tail's
        in_trunk = (int(m.group(1)) < split if m
                    else ".norm." not in f".{name}")
        if in_trunk:
            raise ValueError(f"frozen_trunk_blocks={split} but trainable leaf "
                             f"{name} lies inside the trunk")


def make_train_step(model: TimeT, cfg: TimeTConfig,
                    opt: SwavOptimizer | Zero1Optimizer,
                    trainable_mask: Mapping[str, bool] | None = None,
                    opt_over_trainable: bool = False):
    """Build the train step. Returns ``step_fn(state, clip, generator)``.

    clip: [B, F, H, W, 3] normalised frames (NHWC), on the model's device:
    with ``cfg.axis_name`` this rank's slice of the global batch.
    ``trainable_mask`` (from ``swav_optimizer``) restricts the backward to
    the trainable leaves; ``opt_over_trainable=True`` (with an optimizer
    and a state built the same way) also restricts the EMA to them. The
    trajectory is the full-tree one either way. ``generator`` draws the
    queue's random choice (the rank's own). A ``Zero1Optimizer`` (from
    ``swav_optimizer_zero1``: JAX's ``zero1_plan``) needs
    ``opt_over_trainable`` and a data axis."""
    if opt_over_trainable and trainable_mask is None:
        raise ValueError("opt_over_trainable=True requires trainable_mask")
    zero1 = isinstance(opt, Zero1Optimizer)
    if zero1 and not (opt_over_trainable and cfg.axis_name is not None):
        raise ValueError(
            "ZeRO-1 requires opt_over_trainable=True and a data axis "
            "(it shards the optimizer state across data-parallel ranks)")
    if zero1 and opt.plan.world != cfg.world_size:
        raise ValueError(f"the ZeRO-1 plan splits over {opt.plan.world} ranks, "
                         f"TimeTConfig.world_size is {cfg.world_size}")
    if cfg.moe_aux_weight:
        raise NotImplementedError(
            "TimeTConfig.moe_aux_weight: mixture-of-experts backbones are not "
            f"ported yet ({MOE_ITEM})")
    group = data_group(cfg.axis_name)
    if group is not None and data_world_size(group) != cfg.world_size:
        raise ValueError(f"TimeTConfig.world_size={cfg.world_size} but the process "
                         f"group has {data_world_size(group)} ranks")
    momentum_schedule = cosine_scheduler(
        cfg.ema_start, cfg.ema_end, cfg.num_epochs, cfg.steps_per_epoch)
    res = cfg.spatial_resolution
    split = cfg.frozen_trunk_blocks
    start = 0 if split is None else split
    if split is not None and trainable_mask is not None:
        _check_trunk_is_frozen(split, trainable_mask)

    fe = model.feature_extractor
    # only the dispatcher default is rerouted on the grad path: a forced
    # attn_impl keeps its implementation there too
    bcfg = getattr(fe.backbone, "config", None)
    grad_impl = None
    if (cfg.grad_attn_impl not in (None, "auto") and bcfg is not None
            and getattr(bcfg, "attn_impl", None) == "auto"):
        grad_impl = cfg.grad_attn_impl

    named = dict(model.named_parameters())
    train_names = [n for n in named
                   if trainable_mask is None or trainable_mask[n]]
    train_params = [named[n] for n in train_names]

    def assign(code_protos, feats, queue, queue_ready):
        """First-frame Sinkhorn codes, over batch + queue once the queue is
        full (reference get_scores, time_tuning.py:195-217)."""
        B, N, D = feats.shape
        scores = model.similarity(feats.reshape(B * N, D), code_protos)
        if queue is not None and queue_ready:
            scores = torch.cat([scores, model.similarity(queue, code_protos)])
        q = sinkhorn_assignment(scores, cfg.epsilon, cfg.sinkhorn_iterations,
                                group=group, world_size=cfg.world_size)
        return q[: B * N].reshape(B, N, -1)

    def step_fn(state: TrainState, clip: torch.Tensor,
                generator: torch.Generator | None = None):
        B, Fr, H, W, _ = clip.shape
        with torch.no_grad():
            code = state.teacher if cfg.use_teacher else {}
            code_protos = code.get("prototypes")
            # backbone (no head) features over all frames: the propagation
            # substrate (reference time_tuning.py:238-239)
            frames = clip.reshape(B * Fr, H, W, 3)
            if split is not None:
                trunk = fe.backbone(frames, stop_block=split)["hidden"]
                trunk = trunk.reshape(B, Fr, *trunk.shape[1:])
                tail_in, first, last = trunk.flatten(0, 1), trunk[:, 0], trunk[:, -1]
            else:
                tail_in, first, last = frames, clip[:, 0], clip[:, -1]
            bb_feats, _ = model(tail_in, use_head=False, start_block=start)
            bb_feats = bb_feats.reshape(B, Fr, *bb_feats.shape[1:])

            # source codes: teacher first frame if enabled, else student
            # (time_tuning.py:263-268)
            src_feats, src_attn = functional_call(
                model, code, (first,),
                dict(use_head=True, want_attention=cfg.mask_features,
                     start_block=start))
            if cfg.mask_features:
                masked, _ = apply_attention_mask(src_feats[:, None], src_attn, res)
                src_feats = masked[:, 0]

            # queue FIFO: the reference inserts the batch's first-frame
            # features BEFORE the Sinkhorn (time_tuning.py:250-261 precede
            # get_scores at :263-268), so the assignment sees the rows just
            # stored and the queue turns ready in the step that fills it
            if cfg.use_queue:
                store = src_feats.reshape(-1, src_feats.shape[-1])
                n_store = min(B * 10, cfg.queue_size)
                idx = queue_store_indices(store.shape[0], n_store, generator)
                state.queue = torch.cat(
                    [store[idx.to(store.device)].float(), state.queue[:-n_store]])
                state.queue_fill = min(state.queue_fill + n_store, cfg.queue_size)
            queue_ready = cfg.use_queue and state.queue_fill >= cfg.queue_size

            q = assign(code_protos, src_feats, state.queue, queue_ready)
            # propagate q through the clip over the backbone features
            # (make_seg_maps -> propagate_labels, time_tuning.py:143-154, 285)
            prop = propagate_labels_batch(
                bb_feats, q.transpose(1, 2), n_last=cfg.n_last_frames,
                radius=cfg.size_mask_neighborhood, topk=cfg.topk)
            labels = prop[:, -1].argmax(dim=1)                    # [B, N]

        # grad path: student with head on the last frame
        with torch.enable_grad():
            s_feats, s_attn = model(
                last, use_head=True, want_attention=cfg.mask_features,
                start_block=start, attn_impl=grad_impl)
            if cfg.mask_features:
                masked, mask = apply_attention_mask(s_feats[:, None], s_attn, res)
                s_feats = masked[:, 0]
            logits = model.similarity(s_feats) / cfg.score_temperature
            ce = F.cross_entropy(logits.flatten(0, 1), labels.flatten(),
                                 reduction="none").reshape(labels.shape)
            if cfg.mask_features:
                ce = ce * mask[:, 0]
            loss = ce.mean()
            grads = torch.autograd.grad(loss, train_params, allow_unused=True)

        with torch.no_grad():
            # a leaf the loss does not reach has a zero gradient (and still
            # decays), as under jax.grad
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(train_params, grads)]
            if zero1:
                loss = _zero1_update(state.opt, grads, loss, group)
            else:
                if group is not None:
                    grads, loss = _mean_over_group(grads, loss, group)
                for p, g in zip(train_params, grads):
                    p.grad = g
                state.opt.step()
                state.opt.zero_grad()
            # prototype renorm after the step (time_tuning.py:125-128, 661)
            model.prototypes.copy_(_l2norm(model.prototypes))

            # EMA teacher; leaves it does not hold are the student's own
            m = 0.0
            if cfg.use_teacher:
                m = schedule_at(momentum_schedule, state.step)
                for n, t in state.teacher.items():
                    t.mul_(1.0 - m).add_(named[n].detach() * m)
                if "prototypes" in state.teacher:
                    t = state.teacher["prototypes"]
                    t.copy_(_l2norm(t))
            state.step += 1
        return state, {"loss": loss.detach(), "momentum": m}

    return step_fn


def _mean_over_group(grads: list[torch.Tensor], loss: torch.Tensor, group):
    """``pmean`` of the gradients and the loss: one all-reduce of the flat
    vector [grads..., loss], divided by the group's size."""
    flat = all_reduce_mean(torch.cat([g.reshape(-1).float() for g in grads]
                                     + [loss.detach().float().reshape(1)]), group)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g).to(g.dtype))
        at += g.numel()
    return out, flat[-1]


def _zero1_update(opt: Zero1Optimizer, grads: list[torch.Tensor],
                  loss: torch.Tensor, group) -> torch.Tensor:
    """ZeRO-1 (``timetuning_tpu/core/timet.py:620-665``): the flat gradient
    summed over the group with the loss (JAX's psum_scatter is this
    all-reduce and the rank's slice), divided by the group's size; AdamW on
    the rank's chunk; the full update rebuilt by the all-reduce of the
    zero-scattered chunk updates, added to the flat parameters. Returns the
    mean loss."""
    plan = opt.plan
    world = data_world_size(group)
    g = torch.cat([g.reshape(-1).float() for g in grads])
    flat = torch.cat([g, g.new_zeros(plan.padded - plan.length),
                      loss.detach().float().reshape(1)])
    flat = all_reduce_sum(flat, group)
    g_chunk = opt.chunk_of(flat[:plan.padded]) / world
    p_flat = opt.flat_params()
    u_chunk = opt.update(g_chunk, opt.chunk_of(p_flat))
    u = torch.zeros_like(p_flat)
    opt.chunk_of(u).copy_(u_chunk)
    opt.assign(p_flat + all_reduce_sum(u, group))
    return flat[-1] / world
