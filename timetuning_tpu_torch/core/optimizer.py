"""SwAV-style optimizer: AdamW with three lr groups and scheduled decay.

Counterpart of ``timetuning_tpu/core/optimizer.py`` (reference
``SwavOptimizer``, time_tuning.py:379-429):
  * AdamW; prototypes and projection head at ``lr``, the trainable backbone
    leaves at ``backbone_lr`` (= lr / 10 in the reference's training script, :613);
  * biases and 1-dim parameters take no weight decay (:391-403);
  * the lr cosine-annealed over ``num_steps`` (:383-386);
  * the weight decay itself cosine-scheduled 0.04 -> 0.4 (:427-429, :613).

The JAX package expresses this as one optax chain whose schedules are
functions of the chain's own step counter. Here the schedules are read at
the same counter on the host, before each update, into a small table of
scalars (``SwavOptimizer.scalars``), and the update (``apply``) is torch's
AdamW written on tensors that reads every scheduled value from that table
on the device: a CUDA graph of the train step replays it with each step's
values (``torch.optim.AdamW`` takes its weight decay only as a Python float,
which a graph would freeze). optax's ``p - lr * (adam + wd * p)`` and
torch's decoupled decay ``p * (1 - lr * wd) - lr * adam`` are the same
update.

Which parameters train is a mask over parameter names (``build_masks``),
not ``requires_grad``: backbone leaves train only if their name holds one of
``unfreeze_layers`` as a run of whole segments.

ZeRO-1 (``swav_optimizer_zero1``, beyond the reference, whose DDP ranks each
hold the whole AdamW state): the trainable parameters flattened into one
vector in ``named_parameters()`` order, padded to ``world * chunk``; each
rank holds the Adam moments of its [chunk] and updates that chunk only
(``Zero1Optimizer.update``, the JAX package's ``zero1_tx``). The layouts of
a checkpoint's optimizer state (by parameter name, or the padded flat
moments) convert exactly into each other (``migrate_*``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Mapping, NamedTuple, Sequence

import torch

from timetuning_tpu_torch.core.schedules import cosine_scheduler, schedule_at
from timetuning_tpu_torch.ops.util import pad_to_multiple


def _segments(name: str) -> list[str]:
    """A parameter name or pattern as path segments; accepts the reference's
    ("blocks.11", "feature_extractor.backbone"), the JAX tree's
    ("blocks_11", "a/b") and torch's spellings."""
    return name.replace("/", ".").replace("blocks_", "blocks.").split(".")


def _matches(pattern: str, name: str) -> bool:
    """``pattern`` matches a contiguous run of FULL name segments: substring
    matching would make "blocks.1" also unfreeze blocks 10 to 19."""
    want, segs = _segments(pattern), _segments(name)
    n = len(want)
    return any(segs[i:i + n] == want for i in range(len(segs) - n + 1))


def build_masks(named_params: Mapping[str, torch.Tensor],
                unfreeze_layers: Sequence[str]):
    """(groups, trainable, decay), each a dict over the parameter names.

    Groups: prototypes and heads are ``"head"`` and always train; a backbone
    leaf is ``"backbone"`` if its name matches one of ``unfreeze_layers``,
    else ``"frozen"`` (reference models.py:929-935, time_tuning.py:574).
    Decay: trainable leaves with more than one dimension whose name does not
    end in "bias"."""
    groups = {}
    for name in named_params:
        if "backbone" not in _segments(name):
            groups[name] = "head"
        elif any(_matches(p, name) for p in unfreeze_layers):
            groups[name] = "backbone"
        else:
            groups[name] = "frozen"
    trainable = {n: g != "frozen" for n, g in groups.items()}
    decay = {n: trainable[n] and _decays(n, p) for n, p in named_params.items()}
    return groups, trainable, decay


def _decays(name: str, p: torch.Tensor) -> bool:
    """Weight decay applies to a trainable leaf of more than one dimension
    whose name does not end in "bias" (reference time_tuning.py:391-403)."""
    return p.dim() > 1 and not name.endswith("bias")


class _Schedules:
    """The lr and weight-decay schedules of both optimizers, functions of
    the update count."""

    def _init_schedules(self, lr: float, num_steps: int, use_cosine_lr: bool,
                        wd_start: float, wd_end: float) -> None:
        self.lr = lr
        self.num_steps = num_steps
        self.use_cosine_lr = use_cosine_lr
        self.wd_schedule = cosine_scheduler(wd_start, wd_end, 1, num_steps)
        self.count = 0

    def lr_at(self, count: int) -> float:
        """``optax.cosine_decay_schedule(lr, num_steps, alpha=0)``."""
        if not self.use_cosine_lr:
            return self.lr
        frac = min(count, self.num_steps) / self.num_steps
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * frac))

    def weight_decay_at(self, count: int) -> float:
        return schedule_at(self.wd_schedule, count)


_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class AdamWGroups:
    """``SwavOptimizer``'s groups and moments, in the layout the checkpoint
    writes (torch's optimizer layout): ``param_groups``, dicts of
    ``params``, ``lr_factor``, ``decays`` and the last update's ``lr`` and
    ``weight_decay``; ``state[p]``, the ``exp_avg`` and ``exp_avg_sq`` of
    parameter ``p``."""

    param_groups: list
    state: dict = dataclasses.field(default_factory=dict)


class SwavOptimizer(_Schedules):
    """AdamW (b1 0.9, b2 0.999, eps 1e-8) over the trainable parameters of
    ``named_params``, grouped by (lr group, decays or not).

    An update is three parts: ``scalars()`` reads the schedules at the
    optimizer's own step counter (clamped to the schedules' last entry) on
    the host; ``apply(grads, table)`` updates the parameters and the moments
    on their device, reading those values from ``table`` (a tensor of them
    on that device); ``count += 1`` advances the counter. ``step()`` does
    all three on the ``.grad`` of each parameter. The groups and the
    moments are ``adamw`` (``AdamWGroups``)."""

    def __init__(self, named_params: Mapping[str, torch.Tensor], lr: float,
                 backbone_lr: float, num_steps: int,
                 unfreeze_layers: Sequence[str], wd_start: float, wd_end: float,
                 use_cosine_lr: bool, opt_over_trainable: bool):
        groups, self.trainable_mask, decay = build_masks(named_params,
                                                         unfreeze_layers)
        self.named_params = dict(named_params)
        self._init_schedules(lr, num_steps, use_cosine_lr, wd_start, wd_end)
        factors = {"head": 1.0, "backbone": backbone_lr / lr, "frozen": 0.0}
        param_groups = []
        for group in ("head", "backbone", "frozen"):
            if group == "frozen" and opt_over_trainable:
                continue
            for decays in (True, False):
                params = [p for n, p in named_params.items()
                          if groups[n] == group and decay[n] == decays]
                if params:
                    param_groups.append(dict(
                        params=params, lr_factor=factors[group], decays=decays,
                        lr=lr * factors[group], weight_decay=0.0))
        self.adamw = AdamWGroups(param_groups)
        # the trainable leaves' moments exist from the start, so a train
        # step's tensors keep their addresses from its first call on
        self._moments([p for n, p in self.named_params.items()
                       if self.trainable_mask[n]])

    def scalars(self) -> list[float]:
        """The scheduled values of the next update, host floats in the order
        ``apply`` reads them: 1 / sqrt(1 - b2^t), then per group
        ``1 - lr * wd`` and ``-lr / (1 - b1^t)`` (t = count + 1; torch's
        AdamW computes the same values on the host). Also records the
        group's ``lr`` and ``weight_decay``."""
        t = self.count + 1
        lr, wd = self.lr_at(self.count), self.weight_decay_at(self.count)
        out = [1.0 / (1.0 - _B2 ** t) ** 0.5]
        for g in self.adamw.param_groups:
            g["lr"] = lr * g["lr_factor"]
            g["weight_decay"] = wd if g["decays"] else 0.0
            out += [1.0 - g["lr"] * g["weight_decay"], -g["lr"] / (1.0 - _B1 ** t)]
        return out

    def apply(self, grads: dict, table: torch.Tensor) -> None:
        """One AdamW update of the parameters in ``grads`` (parameter ->
        gradient; the others keep their value and moments), on their
        device, every scheduled value read from ``table`` (``scalars()`` as
        f32, on that device): torch's AdamW as its multi-tensor form orders
        it, no host value that changes from step to step."""
        inv_bc2 = table[0]
        with torch.no_grad():
            for i, g in enumerate(self.adamw.param_groups):
                ps = [p for p in g["params"] if p in grads]
                if not ps:
                    continue
                gs = [grads[p] for p in ps]
                mus, nus = self._moments(ps)
                if g["decays"]:
                    torch._foreach_mul_(ps, table[1 + 2 * i])
                torch._foreach_lerp_(mus, gs, 1.0 - _B1)
                torch._foreach_mul_(nus, _B2)
                torch._foreach_addcmul_(nus, gs, gs, value=1.0 - _B2)
                den = torch._foreach_sqrt(nus)
                torch._foreach_mul_(den, inv_bc2)
                torch._foreach_add_(den, _EPS)
                upd = torch._foreach_div(mus, den)
                torch._foreach_mul_(upd, table[2 + 2 * i])
                torch._foreach_add_(ps, upd)

    def _moments(self, params) -> tuple[list, list]:
        """The AdamW moments of ``params``, zeros where a parameter has none
        yet. Never made inside a CUDA graph capture: they would be zeroed at
        every replay."""
        mus, nus = [], []
        for p in params:
            st = self.adamw.state.setdefault(p, {})
            if not st:
                if p.is_cuda and torch.cuda.is_current_stream_capturing():
                    raise RuntimeError("SwavOptimizer: first update of a parameter "
                                       "inside a CUDA graph capture")
                st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            mus.append(st["exp_avg"])
            nus.append(st["exp_avg_sq"])
        return mus, nus

    def step(self) -> None:
        """One update of every parameter that has a ``.grad``."""
        grads = {p: p.grad for g in self.adamw.param_groups for p in g["params"]
                 if p.grad is not None}
        if grads:
            dev = next(iter(grads)).device
            self.apply(grads, torch.tensor(self.scalars(), dtype=torch.float32,
                                           device=dev))
        self.count += 1

    def zero_grad(self) -> None:
        for g in self.adamw.param_groups:
            for p in g["params"]:
                p.grad = None


def _named(params) -> dict[str, torch.Tensor]:
    return dict(params.named_parameters()
                if isinstance(params, torch.nn.Module) else params)


def swav_optimizer(params: torch.nn.Module | Mapping[str, torch.Tensor]
                   | Iterable[tuple[str, torch.Tensor]],
                   lr: float = 1e-4, backbone_lr: float | None = None,
                   num_steps: int = 100_000,
                   unfreeze_layers: Sequence[str] = ("blocks.11", "blocks.10"),
                   wd_start: float = 0.04, wd_end: float = 0.4,
                   num_epochs: int | None = None,
                   steps_per_epoch: int | None = None,
                   use_cosine_lr: bool = True,
                   opt_over_trainable: bool = False):
    """Build the optimizer over a module's (or a name -> tensor mapping's)
    parameters. Returns (optimizer, trainable_mask).

    ``opt_over_trainable=True`` keeps optimizer state for the trainable
    parameters only; otherwise the frozen ones sit in a group of their own
    with lr 0 and no decay, and never move either way (the JAX chain zeroes
    their gradients): the two trajectories are identical."""
    if backbone_lr is None:
        backbone_lr = lr / 10.0           # reference: time_tuning.py:613
    if num_epochs is not None and steps_per_epoch is not None:
        num_steps = num_epochs * steps_per_epoch
    named = _named(params)
    opt = SwavOptimizer(named, lr, backbone_lr, num_steps,
                        unfreeze_layers, wd_start, wd_end, use_cosine_lr,
                        opt_over_trainable)
    return opt, opt.trainable_mask


class Zero1Plan(NamedTuple):
    """The flat layout of ZeRO-1: the trainable parameters ``names`` (of
    ``shapes``), flattened in that order into ``length`` elements, padded
    with zeros to ``padded = world * chunk``; rank r owns elements
    [r * chunk, (r + 1) * chunk). ``lr_vec`` and ``decay_vec`` [padded] hold
    each element's lr-group factor and 1.0 where weight decay applies (the
    decay mask doubles as the layout's fingerprint)."""

    length: int
    padded: int
    chunk: int
    world: int
    names: tuple
    shapes: tuple
    lr_vec: torch.Tensor
    decay_vec: torch.Tensor


def _flat_of(named_params: Mapping[str, torch.Tensor], names, value) -> torch.Tensor:
    """[sum of the names' sizes] f32: ``value(name)`` over each name's
    elements, in order."""
    parts = [torch.full((named_params[n].numel(),), float(value(n))) for n in names]
    return torch.cat(parts) if parts else torch.zeros(0)


def decay_vector(named_params: Mapping[str, torch.Tensor],
                 trainable_mask: Mapping[str, bool]) -> torch.Tensor:
    """1.0 where weight decay applies, over the flat trainable vector: the
    fingerprint of a ZeRO-1 layout (``build_masks``' decay rule)."""
    names = [n for n in named_params if trainable_mask[n]]
    return _flat_of(named_params, names, lambda n: _decays(n, named_params[n]))


def zero1_plan(named_params: Mapping[str, torch.Tensor], world_size: int,
               lr: float, backbone_lr: float,
               unfreeze_layers: Sequence[str]) -> Zero1Plan:
    groups, trainable, _ = build_masks(named_params, unfreeze_layers)
    factors = {"head": 1.0, "backbone": backbone_lr / lr}
    names = tuple(n for n in named_params if trainable[n])
    length = sum(named_params[n].numel() for n in names)
    padded = pad_to_multiple(length, world_size)

    def pad(v):
        return torch.nn.functional.pad(v, (0, padded - length))

    return Zero1Plan(
        length, padded, padded // world_size, world_size, names,
        tuple(tuple(named_params[n].shape) for n in names),
        pad(_flat_of(named_params, names, lambda n: factors[groups[n]])),
        pad(decay_vector(named_params, trainable)))


def zero1_plan_with_padding(plan: Zero1Plan, padded: int) -> Zero1Plan:
    """``plan`` padded to ``padded`` elements as one chunk: the layout of a
    checkpoint written at another world size, whose padded length is known
    (``core/checkpoint.saved_zero1_padding``)."""
    if padded < plan.length:
        raise ValueError(f"padded={padded} smaller than the trainable length "
                         f"{plan.length}")

    def repad(v):
        out = torch.zeros(padded, dtype=v.dtype)
        out[:plan.length] = v[:plan.length]
        return out

    return plan._replace(padded=padded, chunk=padded, world=1,
                         lr_vec=repad(plan.lr_vec), decay_vec=repad(plan.decay_vec))


def validate_zero1_fingerprint(decay_vec: torch.Tensor, plan: Zero1Plan) -> None:
    """Refuse ZeRO-1 moments written with another trainable set: the 0/1
    weight-decay mask is a fingerprint of the layout."""
    _check_fingerprint(decay_vec, plan.decay_vec[:plan.length])


def _check_fingerprint(saved: torch.Tensor, want: torch.Tensor) -> None:
    n = want.shape[0]
    if saved.shape[0] < n or not torch.equal(saved[:n].cpu(), want):
        raise ValueError("zero1 decay-mask fingerprint mismatch: the "
                         "checkpoint's trainable layout differs from this run's")


class Zero1Optimizer(_Schedules):
    """ZeRO-1 AdamW: this rank's [chunk] of the Adam moments and of the
    per-element factors. ``update(g_chunk, p_chunk)`` is the JAX package's
    ``zero1_tx`` update, elementwise and in optax's order (Adam with bias
    correction, + wd * p where decay applies, times the lr-group factor,
    times -lr), and returns the chunk's update; the train step adds it to
    the parameters (core/timet). The schedules are ``SwavOptimizer``'s."""

    def __init__(self, named_params: Mapping[str, torch.Tensor], plan: Zero1Plan,
                 rank: int, trainable_mask: dict, lr: float, num_steps: int,
                 use_cosine_lr: bool, wd_start: float, wd_end: float):
        self.named_params = dict(named_params)
        self.plan, self.rank = plan, rank
        self.trainable_mask = trainable_mask
        self._init_schedules(lr, num_steps, use_cosine_lr, wd_start, wd_end)
        self.params = [self.named_params[n] for n in plan.names]
        dev = self.params[0].device
        lo = rank * plan.chunk
        self.lr_vec = plan.lr_vec[lo:lo + plan.chunk].to(dev)
        self.decay_vec = plan.decay_vec[lo:lo + plan.chunk].to(dev)
        self.mu = torch.zeros(plan.chunk, dtype=torch.float32, device=dev)
        self.nu = torch.zeros_like(self.mu)

    def flat_params(self) -> torch.Tensor:
        """The trainable parameters as one [padded] f32 vector."""
        flat = torch.cat([p.detach().reshape(-1).float() for p in self.params])
        return torch.nn.functional.pad(flat, (0, self.plan.padded - self.plan.length))

    def chunk_of(self, flat: torch.Tensor) -> torch.Tensor:
        lo = self.rank * self.plan.chunk
        return flat[lo:lo + self.plan.chunk]

    def update(self, g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        b1, b2, eps = 0.9, 0.999, 1e-8
        self.mu = (1.0 - b1) * g + b1 * self.mu
        self.nu = (1.0 - b2) * (g * g) + b2 * self.nu
        t = torch.tensor(self.count + 1, dtype=torch.float32)
        mu_hat = self.mu / (1.0 - torch.tensor(b1, dtype=torch.float32) ** t).to(g.device)
        nu_hat = self.nu / (1.0 - torch.tensor(b2, dtype=torch.float32) ** t).to(g.device)
        u = mu_hat / (torch.sqrt(nu_hat) + eps)
        u = u + self.weight_decay_at(self.count) * p * self.decay_vec
        u = u * self.lr_vec * (-self.lr_at(self.count))
        self.count += 1
        return u

    def assign(self, flat: torch.Tensor) -> None:
        """Copy a [>= length] flat vector into the trainable parameters."""
        at = 0
        with torch.no_grad():
            for p in self.params:
                n = p.numel()
                p.copy_(flat[at:at + n].view_as(p))
                at += n


def swav_optimizer_zero1(params: torch.nn.Module | Mapping[str, torch.Tensor],
                         world_size: int, rank: int = 0, lr: float = 1e-4,
                         backbone_lr: float | None = None,
                         num_steps: int = 100_000,
                         unfreeze_layers: Sequence[str] = ("blocks.11", "blocks.10"),
                         wd_start: float = 0.04, wd_end: float = 0.4,
                         num_epochs: int | None = None,
                         steps_per_epoch: int | None = None,
                         use_cosine_lr: bool = True):
    """ZeRO-1 counterpart of ``swav_optimizer(..., opt_over_trainable=True)``:
    returns ``(optimizer, trainable_mask, plan)``, the optimizer holding rank
    ``rank``'s chunk of a ``world_size``-way split. Its updates are the
    subtree optimizer's, elementwise."""
    if backbone_lr is None:
        backbone_lr = lr / 10.0
    if num_epochs is not None and steps_per_epoch is not None:
        num_steps = num_epochs * steps_per_epoch
    named = _named(params)
    plan = zero1_plan(named, world_size, lr, backbone_lr, unfreeze_layers)
    _, trainable, _ = build_masks(named, unfreeze_layers)
    opt = Zero1Optimizer(named, plan, rank, trainable, lr, num_steps,
                         use_cosine_lr, wd_start, wd_end)
    return opt, trainable, plan


# ---- the layouts of a checkpoint's optimizer state ----------------------
# by name: {"count", "state": {name: {"exp_avg", "exp_avg_sq"}}}
#          (AdamWGroups.state; a name without state has zero moments)
# ZeRO-1:  {"layout": "zero1", "count", "mu", "nu", "decay_vec"}, [padded]


def migrate_subtree_to_zero1(payload: dict, plan: Zero1Plan) -> dict:
    """A by-name optimizer payload as ZeRO-1 flat moments (exact: the same
    values in the plan's order, zeros for the padding and for a name that
    has no AdamW state yet)."""
    state = payload["state"]

    def vec(key):
        parts = []
        for n, shape in zip(plan.names, plan.shapes):
            st = state.get(n)
            t = st[key] if st else torch.zeros(shape)
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"moment {n} has shape {tuple(t.shape)}, the "
                                 f"plan expects {shape}: different trainable set")
            parts.append(t.detach().float().reshape(-1).cpu())
        flat = torch.cat(parts) if parts else torch.zeros(0)
        return torch.nn.functional.pad(flat, (0, plan.padded - plan.length))

    return {"layout": "zero1", "count": int(payload["count"]),
            "mu": vec("exp_avg"), "nu": vec("exp_avg_sq"),
            "decay_vec": plan.decay_vec.clone()}


def migrate_zero1_to_subtree(payload: dict, named_params: Mapping[str, torch.Tensor],
                             trainable_mask: Mapping[str, bool]) -> dict:
    """ZeRO-1 flat moments (of any padding) as a by-name payload over the
    trainable parameters: the exact inverse of ``migrate_subtree_to_zero1``.
    Refuses moments of another trainable set: a nonzero tail past the
    trainable length, or another decay fingerprint."""
    names = [n for n in named_params if trainable_mask[n]]
    length = sum(named_params[n].numel() for n in names)
    mu, nu = payload["mu"], payload["nu"]
    if mu.shape[0] < length:
        raise ValueError(f"zero1 moments have {mu.shape[0]} elements, the "
                         f"trainable set needs {length}: different trainable set")
    for key, v in (("mu", mu), ("nu", nu)):
        tail = v[length:]
        if tail.numel() and tail.abs().max().item() > 0:
            raise ValueError(f"zero1 {key} has nonzero moments beyond the "
                             f"trainable length {length}: the checkpoint was "
                             "written with a different (larger) trainable set")
    _check_fingerprint(payload["decay_vec"], decay_vector(named_params, trainable_mask))
    count = int(payload["count"])
    state, at = {}, 0
    for n in names:
        p = named_params[n]
        k = p.numel()
        if count:
            state[n] = {"exp_avg": mu[at:at + k].reshape(p.shape).clone(),
                        "exp_avg_sq": nu[at:at + k].reshape(p.shape).clone()}
        at += k
    return {"count": count, "state": state}
