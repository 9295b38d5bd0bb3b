"""Pipeline parallelism (the GPipe forward schedule) for the ViT block stack.

Counterpart of ``timetuning_tpu/parallel/pp.py`` (beyond the reference,
whose only distribution is DDP): the transformer's DEPTH is split over the
inner axis of a ``(data, pipe)`` mesh, so each rank holds and runs only
``depth / pp`` blocks.

  * ``keep_stage``: a rank keeps its own stage's blocks and drops the other
    blocks' parameters (JAX shards the stacked stage parameters
    ``P('pipe')``, ``stack_stage_params``); the embedding and the final norm
    stay whole on every rank;
  * the rank's data slice splits into ``n_micro`` microbatches, and
    ``n_micro + pp - 1`` ticks flow them through the stages: each tick stage
    0 takes microbatch ``t`` (bubble ticks recompute the last one) and the
    other stages what they received, the stage runs its blocks through the
    model's own ``Block`` (the single-device dispatch: K1 and K2 up to 1,024
    tokens in bf16, K7, K5/6, K8 and K9 above), and hands the slab to the
    next stage; bubble ticks compute on slabs that nothing reads;
  * the hop (JAX's ``ppermute``) is ``pipe_hop``: one all-reduce over the
    pipe of a ``[pp - 1, B_mb, S, D]`` buffer in which stage ``s`` fills
    slot ``s`` (the last stage sends nothing), so a tick moves ``(pp - 1) x
    B_mb x S x D`` elements a rank, the bytes of the ``ppermute`` at pp 2;
    every collective of the port is an all-reduce or a broadcast, which gloo
    and NCCL both take on CUDA tensors and ``torch.export`` carries as a
    functional collective;
  * the last stage banks the finished microbatches and takes the final
    norm; one all-reduce of its result (zeros elsewhere) leaves the tokens
    on every rank of the pipe (JAX's masked ``psum``).

The backward is the schedule run in reverse (``_GPipe``): each tick's
blocks recomputed from its saved input, their VJP, and the reverse hop,
on every rank whether or not its own output depends on it (JAX runs one
SPMD program; autograd would walk only a rank's own graph). Bubble ticks add
exactly zero, and the parameter gradients of a loss on each rank's output,
summed over the mesh, are the single-device gradients
(tests/test_torch_pp.py). With the default ``n_micro`` (the pipe degree)
the forward's bubble is ``(pp - 1) / (n_micro + pp - 1)`` of the ticks.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from timetuning_tpu_torch.models.vit import VisionTransformer
from timetuning_tpu_torch.ops.fused_block import _ln
from timetuning_tpu_torch.parallel.mesh import (
    Mesh2D,
    all_reduce_sum,
    make_2d_mesh,
    reduce_from_group,
)

DATA_AXIS = "data"
PIPE_AXIS = "pipe"


def make_dp_pp_mesh(dp: int, pp: int, devices=None) -> Mesh2D:
    """2-D (data, pipe) mesh, ``pipe`` over consecutive ranks."""
    return make_2d_mesh(dp, pp, (DATA_AXIS, PIPE_AXIS), devices=devices)


def validate_pp_geometry(config, pp: int, batch: int, dp: int, n_micro: int) -> None:
    """Shardability: depth divides into equal stages, the local batch into
    microbatches."""
    if config.depth % pp:
        raise ValueError(f"depth={config.depth} not divisible by pp={pp}")
    if batch % dp:
        raise ValueError(f"batch={batch} not divisible by dp={dp}")
    if (batch // dp) % n_micro:
        raise ValueError(f"local batch {batch // dp} not divisible by n_micro={n_micro}")


def stage_blocks(depth: int, n_stages: int, stage: int) -> range:
    """The blocks of ``stage`` when ``depth`` blocks split into ``n_stages``
    equal stages (JAX's ``stack_stage_params``)."""
    if depth == 0:
        raise ValueError("param tree has no blocks_i subtrees")
    if depth % n_stages:
        raise ValueError(f"depth={depth} not divisible by pp={n_stages}")
    n = depth // n_stages
    return range(stage * n, (stage + 1) * n)


def keep_stage(mesh: Mesh2D, model) -> range:
    """Keep this rank's stage of ``model``'s blocks (a ``VisionTransformer``,
    in place) and drop the other blocks' parameters: their entries become
    empty modules, so ``state_dict()`` holds this stage's blocks under
    their own names. Returns the stage's block range (also
    ``model.pipe_stage``); a second call returns it again."""
    if getattr(model, "pipe_stage", None) is not None:
        return model.pipe_stage
    if mesh.coords is None:
        raise ValueError("keep_stage: this rank is not on the mesh")
    blocks = stage_blocks(len(model.blocks), mesh.n_inner, mesh.inner_index)
    for i in range(len(model.blocks)):
        if i not in blocks:
            model.blocks[i] = nn.Module()
    model.pipe_stage = blocks
    return blocks


def _auto_n_micro(b_local: int, n_pipe: int) -> int:
    """Largest divisor of the local batch <= the pipe degree (JAX's rule,
    shared with ``cli/export``)."""
    for nm in range(min(b_local, n_pipe), 0, -1):
        if b_local % nm == 0:
            return nm
    return 1


def pipe_hop(x: torch.Tensor, group, stage: int, n_stages: int,
             reverse: bool = False) -> torch.Tensor | None:
    """Each stage hands ``x`` to the next (``reverse``: to the previous) and
    receives the previous one's (``reverse``: the next one's); None on the
    stage that receives nothing. One all-reduce of ``n_stages - 1`` slots,
    each filled by its sender alone, so the sum is exact in any dtype."""
    src = stage - 1 if reverse else stage
    slots = [torch.zeros_like(x) for _ in range(n_stages - 1)]
    if 0 <= src < n_stages - 1:
        slots[src] = x
    got = all_reduce_sum(torch.stack(slots), group)
    dst = stage if reverse else stage - 1
    return got[dst] if 0 <= dst < n_stages - 1 else None


@dataclasses.dataclass
class _Schedule:
    """One rank's GPipe schedule: ``stage_fn`` over ``n_micro`` microbatches
    of [Bmb, S, D] in ``n_micro + n_pipe - 1`` ticks."""

    stage_fn: object
    group: object
    stage: int
    n_pipe: int
    n_micro: int
    shape: tuple          # (B, S, D) of the rank's data slice
    dtype: torch.dtype

    @property
    def ticks(self) -> int:
        return self.n_micro + self.n_pipe - 1

    def hops(self, t: int) -> bool:
        """Whether tick ``t`` hands its slab on (the last tick's is unread)."""
        return self.n_pipe > 1 and t < self.ticks - 1

    def forward(self, h, inputs: list | None = None):
        """The forward ticks (stage 0 reads ``h`` [B, S, D]); each tick's
        input is appended to ``inputs``. Returns the last stage's finished
        microbatches [B, S, D], zeros on the other stages."""
        B, S, D = self.shape
        nm, last, mb = self.n_micro, self.n_pipe - 1, B // self.n_micro
        recv = torch.zeros((mb, S, D), dtype=self.dtype, device=h.device)
        outs = []
        for t in range(self.ticks):
            i = min(t, nm - 1) * mb
            x = h[i:i + mb] if self.stage == 0 else recv
            if inputs is not None:
                inputs.append(x)
            y = self.stage_fn(x)
            if self.stage == last and t >= last:
                outs.append(y)
            if self.hops(t):
                recv = pipe_hop(y, self.group, self.stage, self.n_pipe)
        if self.stage == last:
            return torch.cat(outs)
        return torch.zeros(self.shape, dtype=self.dtype, device=h.device)

    def backward(self, inputs: list, g, params: list):
        """The reverse ticks: each tick's blocks recomputed from its saved
        input, their VJP at the cotangent of its output (the last stage's
        share of ``g``, and what the next stage hands back: the reverse
        hop). Returns (the gradient of ``h`` on stage 0, else None; the
        parameters' gradients)."""
        B, S, D = self.shape
        nm, last, mb = self.n_micro, self.n_pipe - 1, B // self.n_micro
        g_h = torch.zeros(self.shape, dtype=g.dtype, device=g.device) if self.stage == 0 else None
        g_params = [None] * len(params)
        g_next = torch.zeros((mb, S, D), dtype=g.dtype, device=g.device)
        for t in reversed(range(self.ticks)):
            gy = torch.zeros_like(g_next)
            if self.stage == last and t >= last:
                gy = gy + g[(t - last) * mb:(t - last + 1) * mb]
            if self.hops(t):
                back = pipe_hop(g_next, self.group, self.stage, self.n_pipe, reverse=True)
                if back is not None:
                    gy = gy + back
            with torch.enable_grad():
                x = inputs[t].detach().requires_grad_(True)
                y = self.stage_fn(x)
                g_x, *gp = torch.autograd.grad(y, [x, *params], gy.to(y.dtype),
                                               allow_unused=True)
            g_params = [a if b is None else (b if a is None else a + b)
                        for a, b in zip(g_params, gp)]
            if self.stage == 0:
                i = min(t, nm - 1) * mb
                g_h[i:i + mb] += g_x
            else:
                g_next = g_x.to(g.dtype)
        return g_h, g_params


class _GPipe(torch.autograd.Function):
    """The schedule forward, its reverse ticks backward: every rank runs
    the same collectives in the same order both ways, whether or not its
    own output depends on them (JAX runs one SPMD program)."""

    @staticmethod
    def forward(ctx, sched, h, *params):
        ctx.sched, ctx.params, ctx.inputs = sched, params, []
        return sched.forward(h, ctx.inputs)

    @staticmethod
    def backward(ctx, g):
        g_h, g_params = ctx.sched.backward(ctx.inputs, g, list(ctx.params))
        return (None, g_h, *g_params)


def pp_forward_fn(model, mesh: Mesh2D, n_micro: int | None = None):
    """The pipeline-parallel forward of ``model`` (a ``VisionTransformer``)
    on ``mesh`` (``make_dp_pp_mesh``), differentiable. Keeps this rank's
    stage of the blocks (``keep_stage``). ``fwd(images)`` takes this rank's
    data slice [B/dp, H, W, 3] and returns its final-norm tokens [B/dp, 1 +
    N, D] on every rank of the pipe. ``n_micro=None`` picks the largest
    divisor of the local batch <= the pipe degree; the geometry is checked
    at each call (``validate_pp_geometry``). Under grad the blocks' inputs
    of every tick are kept and the blocks recomputed in the backward, one
    tick at a time (``ViTConfig.remat`` is implied)."""
    if not isinstance(model, VisionTransformer):
        raise ValueError(f"pipeline parallelism runs the port's VisionTransformer; a "
                         f"{type(model).__name__} runs on one device")
    cfg = model.config
    if getattr(cfg, "moe_every_k", 0):
        raise ValueError(
            "pipeline parallelism does not support MoE ViTs (MoE and dense "
            "blocks have different param trees, so stages cannot be stacked "
            "uniformly) — shard the experts instead (parallel/ep.py)")
    if getattr(cfg, "rope_base", 0):
        raise ValueError("pipeline parallelism runs ViTs with learned positions; a "
                         "RoPE ViT (DINOv3) runs on one device")
    n_pipe, dp = mesh.n_inner, mesh.n_outer
    blocks = keep_stage(mesh, model)
    stage = mesh.inner_index
    params = [p for i in blocks for p in model.blocks[i].parameters()]

    def stage_fn(x):
        for i in blocks:
            x, _ = model.blocks[i](x)
        return x

    def fwd(images):
        B = images.shape[0]
        nm = n_micro or _auto_n_micro(B, n_pipe)
        validate_pp_geometry(cfg, n_pipe, B * dp, dp, nm)
        S = 1 + (images.shape[1] // cfg.patch_size) * (images.shape[2] // cfg.patch_size)
        sched = _Schedule(stage_fn, mesh.inner, stage, n_pipe, nm, (B, S, cfg.embed_dim),
                          cfg.dtype)
        h = (model(images, stop_block=0)["hidden"] if stage == 0
             else images.new_zeros((), dtype=cfg.dtype))
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            out = _GPipe.apply(sched, h, *params)
        else:
            out = sched.forward(h)
        if stage == n_pipe - 1:
            out = _ln(out, model.norm.weight, model.norm.bias)
        return reduce_from_group(out, mesh.inner)

    return fwd


def make_pp_feature_fn(model, mesh: Mesh2D, n_micro: int | None = None):
    """``pp_forward_fn`` with no gradient: ``fwd(images)`` -> this rank's
    data slice's tokens."""
    fwd = pp_forward_fn(model, mesh, n_micro)

    @torch.no_grad()
    def feature_fn(images):
        return fwd(images)

    return feature_fn
