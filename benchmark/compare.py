"""The numbers that decide ``correct``: what the timed path produced against
the plain reference, each a gap that a limit (``benchmark/limits/<cell>.json``)
bounds from above."""

from __future__ import annotations

import numpy as np
import torch


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def leaf_norm_gap(got: dict, want: dict, leaves=None) -> float:
    """The worst leaf's gap between the norms of ``got[k]`` and
    ``want[k]``, against the larger of that leaf's reference norm and the
    median leaf's: some gradients are all but zero."""
    keys = list(want) if leaves is None else list(leaves)
    g = {k: float(torch.linalg.vector_norm(got[k].double())) for k in keys}
    w = {k: float(torch.linalg.vector_norm(want[k].double())) for k in keys}
    med = float(np.median(list(w.values())))
    return max(abs(g[k] - w[k]) / max(w[k], med, 1e-30) for k in keys)


def moving_leaves(first_grads: dict, share: float = 1e-3) -> list:
    """Leaves whose reference gradient is not nought to rounding: its norm at
    least ``share`` of the median leaf's (a key's bias under the softmax
    moves under Adam by round-off alone)."""
    n = {k: float(torch.linalg.vector_norm(v.double())) for k, v in first_grads.items()}
    med = float(np.median(list(n.values())))
    return [k for k, v in n.items() if v >= share * med]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` each hold ``losses`` (steps 1-3), ``grads`` (the
    first step's gradient by leaf), ``init`` and ``after`` (the trained
    leaves before step 1 and after step 3)."""
    loss = max(rel_gap(a, b) for a, b in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]) or not np.isfinite(prog["losses"]).all():
        loss = float("inf")
    moving = moving_leaves(ref["grads"])
    dp = {k: prog["after"][k] - prog["init"][k] for k in moving}
    dr = {k: ref["after"][k] - ref["init"][k] for k in moving}
    return {"loss_gap": loss,
            "grad_norm_gap": leaf_norm_gap(prog["grads"], ref["grads"]),
            "change_norm_gap": leaf_norm_gap(dp, dr)}


@torch.no_grad()
def token_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst token's ||got - want|| / ||want|| over one request's
    features [..., D]: one token answered wrong shows."""
    d = torch.linalg.vector_norm(got.double() - want.double(), dim=-1)
    return float((d / torch.linalg.vector_norm(want.double(), dim=-1).clamp(min=1e-30)).max())
