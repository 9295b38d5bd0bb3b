"""Tensor parallelism for the ViT backbone.

Counterpart of ``timetuning_tpu/parallel/tp.py`` (beyond the reference,
which has no TP: SURVEY.md §2.2). JAX jits one GSPMD program over a
``(data, model)`` mesh with Megatron PartitionSpecs and lets the partitioner
insert the collectives. Here the same layout is held by hand:

  * ``make_dp_tp_mesh``: the 2-D process groups, ``model`` over consecutive
    ranks (parallel/mesh.make_2d_mesh);
  * the one Megatron rule table ``_MEGATRON_RULES`` on the port's names:
    qkv and fc1 column parallel (a rank holds its heads' q, k and v rows and
    its slice of the hidden), proj and fc2 row parallel (the matching input
    columns), everything else replicated;
  * ``shard_params`` keeps a rank's slices in place and sets each block's
    model group; the block (models/vit.Block) then runs the plain
    composition with ``copy_to_group`` before the column-parallel products
    and one ``reduce_from_group`` at the end of each residual branch.

JAX's qkv spec ``P(None, 'model')`` splits the ``[D, 3D]`` kernel into
contiguous thirds and GSPMD reshards after the ``[3, H, Dh]`` reshape; a
hand-written split must give each rank the q, k and v columns of its own
heads instead (``ShardSpec(0, parts=3)``). The gathered layout (checkpoint,
export, eval: ``gather_global_params``) is the whole one. Under TP the
backbone runs plain attention (``force_xla_attention``): the block kernels
take whole weights.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from timetuning_tpu_torch.parallel.mesh import (
    Mesh2D,
    ShardSpec,
    make_2d_mesh,
    param_sharding,
    shard_module,
)

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_dp_tp_mesh(dp: int, tp: int, devices=None) -> Mesh2D:
    """2-D (data, model) mesh, ``model`` over consecutive ranks."""
    return make_2d_mesh(dp, tp, (DATA_AXIS, MODEL_AXIS), devices=devices)


# The ONE Megatron rule table (name suffix -> spec) behind the parameter and
# the state lookups, so the forward and the training shardings cannot drift
# apart. Torch weights are [out, in]: column parallel splits dim 0, row
# parallel dim 1; qkv's output holds q, k and v, each split by heads.
_MEGATRON_RULES = (
    ("attn.qkv.weight", 2, ShardSpec(0, 3)),     # column parallel
    ("mlp.fc1.weight", 2, ShardSpec(0)),
    ("attn.qkv.bias", 1, ShardSpec(0, 3)),
    ("mlp.fc1.bias", 1, ShardSpec(0)),
    ("attn.proj.weight", 2, ShardSpec(1)),       # row parallel (reduce after)
    ("mlp.fc2.weight", 2, ShardSpec(1)),
)


def _suffix_spec(name: str, ndim: int) -> ShardSpec | None:
    for suffix, nd, spec in _MEGATRON_RULES:
        if (name == suffix or name.endswith("." + suffix)) and ndim == nd:
            return spec
    return None


def vit_param_specs(named: Mapping[str, torch.Tensor]) -> dict[str, ShardSpec | None]:
    """Name -> ``ShardSpec`` (None: replicated) for a (possibly nested)
    module's parameters holding a ViT."""
    return {k: _suffix_spec(k, v.dim()) for k, v in named.items()}


def validate_tp_geometry(config, tp: int) -> None:
    """Shardability: the heads and the MLP hidden must divide."""
    if config.num_heads % tp != 0:
        raise ValueError(f"num_heads={config.num_heads} not divisible by tp={tp}")
    hidden = int(config.embed_dim * config.mlp_ratio)
    if (3 * config.embed_dim) % tp or hidden % tp:
        raise ValueError(f"widths not divisible by tp={tp}")


def _vit_blocks(module):
    from timetuning_tpu_torch.models.vit import Block

    return [m for m in module.modules() if isinstance(m, Block)]


def shard_params(mesh: Mesh2D, module):
    """Keep this rank's Megatron slices of every ViT block in ``module`` (in
    place; the ``Parameter`` objects kept) and set the blocks' model group.
    Returns the ``ParamSharding`` (also ``module.param_sharding``); build
    the optimizer after this."""
    blocks = _vit_blocks(module)
    if not blocks:
        raise ValueError("shard_params needs a module holding ViT blocks")
    for b in blocks:
        if b.attn.num_heads % mesh.n_inner:
            raise ValueError(f"num_heads={b.attn.num_heads} not divisible by "
                             f"tp={mesh.n_inner}")
        b.tp_group = mesh.inner
    specs = {k: v for k, v in vit_param_specs(dict(module.named_parameters())).items()
             if v is not None}
    return shard_module(module, specs, mesh)


def force_xla_attention(model):
    """Route the model's backbone onto the plain attention blocks (in place;
    returns the model): the block kernels take whole weights. A no-op for a
    backbone without ``attn_impl`` or already plain."""
    bb = model.feature_extractor.backbone
    cfg = getattr(bb, "config", None)
    if cfg is None or getattr(cfg, "attn_impl", "xla") == "xla":
        return model
    bb.config = dataclasses.replace(cfg, attn_impl="xla")
    for b in _vit_blocks(bb):
        b.attn_impl = "xla"
    return model


def tp_feature_fn(model, mesh: Mesh2D):
    """``tp_feature_fn(backbone, mesh)(state_dict)``: load the whole weights
    into ``model`` (a ``VisionTransformer``), keep this rank's slices, and
    return ``fwd(x)``: this rank's slice of the batch (``P('data')``) -> its
    final-norm tokens, no grad."""

    def make(state_dict):
        model.load_state_dict(state_dict)
        shard_params(mesh, model)

        @torch.no_grad()
        def fwd(x):
            return model(x)["tokens"]

        return fwd

    return make


def timet_state_shardings(state, mesh: Mesh2D) -> dict[str, object]:
    """What a rank holds of each tensor of a TimeT ``TrainState`` on a (data,
    model) mesh: the Megatron ``ShardSpec`` by name suffix for the student,
    the EMA teacher and the AdamW moments (which are keyed by parameter
    name), "replicated" for everything else, the feature queue included
    (the one global FIFO, held whole)."""
    from timetuning_tpu_torch.core.timet import state_tensors

    out = {}
    for k, t in state_tensors(state).items():
        name = k.rsplit(".", 1)[0] if k.startswith("opt.") else k
        out[k] = _suffix_spec(name, t.dim()) or "replicated"
    return out


def validate_tp_step(model, cfg, mesh: Mesh2D):
    """The preconditions of the TP step: one global program
    (``axis_name=None, world_size=1``), heads and hidden that divide; the
    backbone rerouted onto plain attention (returned)."""
    if cfg.axis_name is not None or cfg.world_size != 1:
        raise ValueError(
            "the TP step partitions a single global program: build TimeTConfig "
            "with axis_name=None, world_size=1 (the data-axis reductions are "
            "the mesh's)")
    bcfg = getattr(model.feature_extractor.backbone, "config", None)
    if bcfg is not None:
        validate_tp_geometry(bcfg, mesh.n_inner)
    return force_xla_attention(model)


def make_tp_train_step(model, cfg, opt, mesh: Mesh2D, state_like=None,
                       trainable_mask=None, opt_over_trainable: bool = False):
    """The TimeT train step over a (data, model) mesh with the single-device
    step's semantics: the one global feature FIFO, the Sinkhorn over the
    data axis, the gradients averaged over it, the model axis's all-reduces
    in the blocks. ``model`` is a TimeT whose blocks ``shard_params`` has
    split (before the optimizer and ``state_like`` were built). Returns
    ``(step_fn, shardings)``."""
    from timetuning_tpu_torch.core.timet import make_train_step

    model = validate_tp_step(model, cfg, mesh)
    step = make_train_step(model, cfg, opt, trainable_mask=trainable_mask,
                           opt_over_trainable=opt_over_trainable, mesh=mesh)
    return step, (None if state_like is None else timet_state_shardings(state_like, mesh))


def gather_global_params(module) -> dict[str, torch.Tensor]:
    """The whole state dict of a possibly sharded ``module``, on the CPU. A
    COLLECTIVE over the model axis: every rank calls it, even where only
    rank 0 uses the result (its eval and export)."""
    sharding = param_sharding(module)
    sd = module.state_dict()
    if sharding is not None:
        sd = sharding.gather_state_dict(sd)
    return {k: v.detach().cpu() for k, v in sd.items()}


def put_state_global(module, full: Mapping[str, torch.Tensor]) -> None:
    """Load a whole state dict into a possibly sharded ``module``: each rank
    takes its slices."""
    sharding = param_sharding(module)
    if sharding is not None:
        full = sharding.local_state_dict(full)
    module.load_state_dict(full)
