"""SwAV-style optimizer: AdamW with three lr groups and scheduled decay.

Counterpart of ``timetuning_tpu/core/optimizer.py`` (reference
``SwavOptimizer``, time_tuning.py:379-429):
  * AdamW; prototypes and projection head at ``lr``, the trainable backbone
    leaves at ``backbone_lr`` (= lr / 10 in the reference's training script, :613);
  * biases and 1-dim parameters take no weight decay (:391-403);
  * the lr cosine-annealed over ``num_steps`` (:383-386);
  * the weight decay itself cosine-scheduled 0.04 -> 0.4 (:427-429, :613).

The JAX package expresses this as one optax chain whose schedules are
functions of the chain's own step counter. Here it is a
``torch.optim.AdamW`` whose groups' ``lr`` and ``weight_decay`` are set
from the same schedules, by the same counter, before each update: optax's
``p - lr * (adam + wd * p)`` and torch's decoupled decay
``p * (1 - lr * wd) - lr * adam`` are the same update.

Which parameters train is a mask over parameter names (``build_masks``),
not ``requires_grad``: backbone leaves train only if their name holds one of
``unfreeze_layers`` as a run of whole segments.
"""

from __future__ import annotations

import math
from typing import Iterable, Mapping, Sequence

import torch

from timetuning_tpu_torch.core.schedules import cosine_scheduler, schedule_at


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
    decay = {n: trainable[n] and p.dim() > 1 and not n.endswith("bias")
             for n, p in named_params.items()}
    return groups, trainable, decay


class SwavOptimizer:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8) over the trainable parameters of
    ``named_params``, grouped by (lr group, decays or not). ``step()`` sets
    every group's lr and weight decay from the schedules at the optimizer's
    own step counter (clamped to the schedules' last entry), applies the
    update to the ``.grad`` of each parameter, and advances the counter."""

    def __init__(self, named_params: Mapping[str, torch.Tensor], lr: float,
                 backbone_lr: float, num_steps: int,
                 unfreeze_layers: Sequence[str], wd_start: float, wd_end: float,
                 use_cosine_lr: bool, opt_over_trainable: bool):
        groups, self.trainable_mask, decay = build_masks(named_params,
                                                         unfreeze_layers)
        self.lr = lr
        self.num_steps = num_steps
        self.use_cosine_lr = use_cosine_lr
        self.wd_schedule = cosine_scheduler(wd_start, wd_end, 1, num_steps)
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
                        params=params, lr_factor=factors[group], decays=decays))
        self.count = 0
        self.adamw = torch.optim.AdamW(param_groups, lr=lr, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=0.0)

    def lr_at(self, count: int) -> float:
        """``optax.cosine_decay_schedule(lr, num_steps, alpha=0)``."""
        if not self.use_cosine_lr:
            return self.lr
        frac = min(count, self.num_steps) / self.num_steps
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * frac))

    def weight_decay_at(self, count: int) -> float:
        return schedule_at(self.wd_schedule, count)

    def step(self) -> None:
        lr, wd = self.lr_at(self.count), self.weight_decay_at(self.count)
        for g in self.adamw.param_groups:
            g["lr"] = lr * g["lr_factor"]
            g["weight_decay"] = wd if g["decays"] else 0.0
        self.adamw.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)


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
    named = dict(params.named_parameters()
                 if isinstance(params, torch.nn.Module) else params)
    opt = SwavOptimizer(named, lr, backbone_lr, num_steps,
                        unfreeze_layers, wd_start, wd_end, use_cosine_lr,
                        opt_over_trainable)
    return opt, opt.trainable_mask
