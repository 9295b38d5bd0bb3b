"""Expert parallelism for mixture-of-experts MLP layers.

Counterpart of ``timetuning_tpu/parallel/ep.py`` (beyond the reference,
which has no MoE layers: SURVEY.md §2.2).

``MoEMlp`` is the Switch top-1 MLP: a router scores each token over
``n_experts``, top-1 routing with a capacity factor gives each token a slot
in its expert's buffer (tokens past the capacity get 0, so the residual
passes them through), and the experts' FFNs are batched products over the
expert-stacked weights ``[E, D, H]`` / ``[E, H, D]``. Dispatch, experts and
combine are ``torch.einsum``: JAX computes them in XLA, outside any Pallas
kernel.

Expert parallelism on a ``(data, expert)`` mesh (``make_dp_ep_mesh``): JAX
shards the stacked weights ``P('expert')`` and the batch ``P('data')`` and
lets GSPMD insert the token all-to-alls. The ranks of one expert row see the
same tokens, so here each rank routes all of them, runs only its ``E / ep``
experts on their ``[E/ep, G, C, D]`` buffers, forms its part of the combine,
and one all-reduce over the expert group sums the parts: the same math with
no all-to-all (every collective of the port is an all-reduce or a
broadcast). The tokens and the gates enter the partial computation through
``copy_to_group``, so the gradient that reaches the router and the
replicated activations is the whole one on every rank.

The Switch load-balance auxiliary is collected, not returned: inside
``collect_aux()`` each ``MoEMlp`` appends its value to the list the context
yields (JAX's ``sow`` into ``intermediates``, which the train step reads
when ``TimeTConfig.moe_aux_weight`` > 0); outside it, it is not computed.
"""

from __future__ import annotations

import contextlib
import re
from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from timetuning_tpu_torch.parallel.mesh import (
    Mesh2D,
    ShardSpec,
    copy_to_group,
    make_2d_mesh,
    reduce_from_group,
    shard_module,
)

DATA_AXIS = "data"
EXPERT_AXIS = "expert"

_EXPERT_LEAVES = ("w1", "b1", "w2", "b2")
_AUX: list | None = None


def make_dp_ep_mesh(dp: int, ep: int, devices=None) -> Mesh2D:
    """2-D (data, expert) mesh, ``expert`` over consecutive ranks."""
    return make_2d_mesh(dp, ep, (DATA_AXIS, EXPERT_AXIS), devices=devices)


@contextlib.contextmanager
def collect_aux():
    """Collect the auxiliaries of the ``MoEMlp`` calls made while open."""
    global _AUX
    prev, _AUX = _AUX, []
    try:
        yield _AUX
    finally:
        _AUX = prev


def switch_capacity(tokens_per_group: int, capacity_factor: float, n_experts: int) -> int:
    """``C = ceil(S_g * f / E)``, at least 1."""
    return max(1, int(-(-tokens_per_group * capacity_factor // n_experts)))


class MoEMlp(nn.Module):
    """Switch-style top-1 MoE MLP: [B, S, D] -> [B, S, D].

    ``group_size``: -1 one routing group a sample (the MoE ViT's), 0 one
    global group over all B*S tokens, > 0 that many tokens a group (it must
    divide B*S). Capacity slots are per (group, expert), given in token
    order. The parameters are ``router`` (a bias-free Linear D -> E) and the
    stacked ``w1`` [E, D, H], ``b1`` [E, H], ``w2`` [E, H, D], ``b2`` [E, D];
    under expert parallelism a rank holds ``E / ep`` of them
    (``shard_experts``) and ``expert_group`` is set."""

    def __init__(self, dim: int, n_experts: int, hidden_dim: int,
                 capacity_factor: float = 1.25, group_size: int = 0):
        super().__init__()
        self.n_experts = n_experts
        self.capacity_factor = capacity_factor
        self.group_size = group_size
        self.router = nn.Linear(dim, n_experts, bias=False)
        self.w1 = nn.Parameter(torch.zeros(n_experts, dim, hidden_dim))
        self.b1 = nn.Parameter(torch.zeros(n_experts, hidden_dim))
        self.w2 = nn.Parameter(torch.zeros(n_experts, hidden_dim, dim))
        self.b2 = nn.Parameter(torch.zeros(n_experts, dim))
        self.expert_group = None    # the expert axis's group, and this
        self.expert_index = 0       # rank's index on it

    def init_experts(self, generator: torch.Generator) -> None:
        """LeCun normal (truncated at two deviations) for the stacked FFN
        kernels over their input width, zero biases."""
        with torch.no_grad():
            for w in (self.w1, self.w2):
                std = w.shape[1] ** -0.5
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
            self.b1.zero_()
            self.b2.zero_()

    def groups(self, B: int, S: int) -> tuple[int, int]:
        T = B * S
        if self.group_size == -1:
            return B, S
        if self.group_size == 0:
            return 1, T
        if T % self.group_size:
            raise ValueError(f"group_size={self.group_size} does not divide "
                             f"B*S={T} tokens")
        return T // self.group_size, self.group_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        E, dt = self.n_experts, x.dtype
        G, Sg = self.groups(B, S)
        C = switch_capacity(Sg, self.capacity_factor, E)

        xg = x.reshape(G, Sg, D)
        logits = F.linear(xg, self.router.weight.to(dt))            # [G, Sg, E]
        probs = torch.softmax(logits.float(), dim=-1)
        expert = probs.argmax(dim=-1)                               # [G, Sg]
        gate = probs.gather(-1, expert[..., None])[..., 0]
        onehot = F.one_hot(expert, E).float()                      # [G, Sg, E]
        if _AUX is not None:
            # Switch eqs. 4-6: E * sum_e f_e * P_e a group, mean over groups
            # (1 when balanced, E when collapsed)
            _AUX.append((E * (onehot.mean(1) * probs.mean(1)).sum(-1)).mean())
        # each token's slot in its (group, expert) buffer, in token order
        pos = torch.cumsum(onehot, dim=1) * onehot - 1.0
        kept = (pos < C) & (onehot > 0)
        slot = pos.clamp(0, C - 1).long()
        dispatch = F.one_hot(slot, C).float() * kept[..., None]     # [G, Sg, E, C]

        # this rank's experts; the tokens and the gates are replicated over
        # the expert group and enter its partial computation here
        group = self.expert_group
        n = self.w1.shape[0]
        lo = self.expert_index * n
        dispatch = dispatch[:, :, lo:lo + n]
        combine = dispatch * copy_to_group(gate, group)[..., None, None]
        xin = torch.einsum("gsec,gsd->egcd", dispatch.to(dt),
                           copy_to_group(xg, group))                # [e, G, C, D]
        h = torch.einsum("egcd,edh->egch", xin, self.w1.to(dt))
        h = F.gelu(h + self.b1[:, None, None, :].to(dt), approximate="none")
        out = torch.einsum("egch,ehd->egcd", h, self.w2.to(dt))
        out = out + self.b2[:, None, None, :].to(dt)
        yt = torch.einsum("gsec,egcd->gsd", combine.to(dt), out)
        return reduce_from_group(yt, group).reshape(B, S, D).to(dt)


def validate_ep_geometry(n_experts: int, ep: int) -> None:
    if n_experts % ep:
        raise ValueError(f"n_experts={n_experts} not divisible by ep={ep}")


def _is_expert_leaf(name: str, t: torch.Tensor, n_experts: int | None) -> bool:
    stacked = name.split(".")[-1] in _EXPERT_LEAVES and t.dim() >= 1
    if stacked and n_experts is not None:
        stacked = t.shape[0] == n_experts
    return stacked


def ep_param_specs(named: Mapping[str, torch.Tensor],
                   n_experts: int | None = None) -> dict[str, ShardSpec | None]:
    """Name -> ``ShardSpec(0)`` for the expert-stacked FFN leaves (``w1``,
    ``b1``, ``w2``, ``b2``), None (replicated) for everything else, the
    routers included. With ``n_experts``, a leaf of those names is stacked
    only if its leading axis is that count: another parameter that reuses
    the names stays replicated."""
    return {k: ShardSpec(0) if _is_expert_leaf(k, v, n_experts) else None
            for k, v in named.items()}


def shard_experts(mesh: Mesh2D, module: nn.Module):
    """Keep this rank's ``E / ep`` experts of every ``MoEMlp`` in ``module``
    (in place, the ``Parameter`` objects kept) and set their expert group.
    Returns the ``ParamSharding`` (also ``module.param_sharding``)."""
    moes = {n: m for n, m in module.named_modules() if isinstance(m, MoEMlp)}
    if not moes:
        raise ValueError("shard_experts needs a module with MoE blocks")
    for m in moes.values():
        validate_ep_geometry(m.n_experts, mesh.n_inner)
        m.expert_group, m.expert_index = mesh.inner, mesh.inner_index
    specs = {f"{n}.{leaf}" if n else leaf: ShardSpec(0)
             for n in moes for leaf in _EXPERT_LEAVES}
    return shard_module(module, specs, mesh)


def make_ep_moe_fn(module: MoEMlp, mesh: Mesh2D):
    """Expert-parallel forward factory: ``make(state_dict)`` loads the whole
    layer's weights into ``module``, keeps this rank's experts and returns
    ``fwd(x)`` on this rank's slice of the batch (``P('data')``). The same
    function as the one-process layer."""
    validate_ep_geometry(module.n_experts, mesh.n_inner)

    def make(state_dict):
        module.load_state_dict(state_dict)
        shard_experts(mesh, module)
        return module.forward

    return make


def upcycle_dense_to_moe(dense: Mapping[str, torch.Tensor],
                         moe: Mapping[str, torch.Tensor], cfg) -> dict[str, torch.Tensor]:
    """Sparse upcycling (JAX ``upcycle_dense_to_moe``): a MoE ViT's state
    dict from a DENSE one. Every leaf the two share is copied; each MoE
    block's experts all start as copies of the dense block's MLP, and its
    router keeps ``moe``'s init, so the first MoE output is the dense
    output scaled by the top-1 gate. Names may carry a prefix (the same on
    both)."""
    out = {k: (dense[k] if k in dense else v).clone() for k, v in moe.items()}
    E = cfg.n_experts
    for k in moe:
        m = re.fullmatch(r"(.*)moe\.w1", k)
        if not m:
            continue
        mlp = m.group(1) + "mlp."
        w1, b1 = dense[mlp + "fc1.weight"], dense[mlp + "fc1.bias"]
        w2, b2 = dense[mlp + "fc2.weight"], dense[mlp + "fc2.bias"]
        out[m.group(1) + "moe.w1"] = w1.t().unsqueeze(0).repeat(E, 1, 1)
        out[m.group(1) + "moe.b1"] = b1.unsqueeze(0).repeat(E, 1)
        out[m.group(1) + "moe.w2"] = w2.t().unsqueeze(0).repeat(E, 1, 1)
        out[m.group(1) + "moe.b2"] = b2.unsqueeze(0).repeat(E, 1)
    return out


def make_ep_feature_fn(model, mesh: Mesh2D):
    """Expert-parallel dense-feature forward of a MoE ``VisionTransformer``:
    ``make(state_dict)`` loads the whole weights into ``model``, keeps this
    rank's experts, and returns ``fwd(x)`` (this rank's slice of the batch
    -> its final-norm tokens, no grad)."""
    cfg = model.config
    if not getattr(cfg, "moe_every_k", 0):
        raise ValueError(
            "make_ep_feature_fn needs a MoE ViT (set ViTConfig.moe_every_k and "
            "n_experts); a dense backbone has no expert axis to shard")
    validate_ep_geometry(cfg.n_experts, mesh.n_inner)

    def make(state_dict):
        model.load_state_dict(state_dict)
        shard_experts(mesh, model)

        @torch.no_grad()
        def fwd(x):
            return model(x)["tokens"]

        return fwd

    return make


def ep_state_shardings(state, mesh: Mesh2D, n_experts: int) -> dict[str, object]:
    """What a rank holds of each tensor of a TimeT ``TrainState`` on a (data,
    expert) mesh: ``ShardSpec(0)`` for the expert-stacked leaves of the
    student, the teacher and the AdamW moments, "replicated" for the rest,
    the feature queue included (the one global FIFO, held whole)."""
    from timetuning_tpu_torch.core.timet import state_tensors

    return {k: ShardSpec(0) if ".moe." in f".{k}" and _is_expert_leaf(k, t, None)
            and t.shape[0] == n_experts // mesh.n_inner else "replicated"
            for k, t in state_tensors(state).items()}


def make_ep_train_step(model, cfg, opt, mesh: Mesh2D, state_like=None,
                       trainable_mask=None, opt_over_trainable: bool = False):
    """The TimeT train step under dp x ep with the single-device step's
    semantics (``core/timet.make_train_step`` on the mesh): ``model`` is a
    TimeT with a MoE ViT backbone whose experts ``shard_experts`` has split
    (before the optimizer and ``state_like`` were built); ``cfg.axis_name``
    must be None. Returns ``(step_fn, shardings)``."""
    from timetuning_tpu_torch.core.timet import make_train_step

    vcfg = model.feature_extractor.backbone.config
    if not getattr(vcfg, "moe_every_k", 0):
        raise ValueError("make_ep_train_step needs a MoE ViT backbone")
    validate_ep_geometry(vcfg.n_experts, mesh.n_inner)
    if cfg.axis_name is not None:
        raise ValueError("dp x ep runs as a single global program: set "
                         "axis_name=None (the mesh owns the collectives)")
    step = make_train_step(model, cfg, opt, trainable_mask=trainable_mask,
                           opt_over_trainable=opt_over_trainable, mesh=mesh)
    shardings = None if state_like is None else ep_state_shardings(
        state_like, mesh, vcfg.n_experts)
    return step, shardings
