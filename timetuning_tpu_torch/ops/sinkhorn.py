"""Sinkhorn-Knopp optimal-transport assignment.

Counterpart of ``timetuning_tpu/ops/sinkhorn.py`` (reference
my_utils.py:246-274, the non-log-space Sinkhorn with its global,
cross-process normalisation). The iteration is the diagonal-scaling form:
Sinkhorn only rescales rows and columns, so Q_t = diag(a) Q_0 diag(b) and an
iteration is two matrix-vector products against the unchanged Q_0, with no
[K, B] matrix written per iteration. Here it is plain ``torch.mv``.

Dispatch (``sinkhorn_assignment``, ``sinkhorn_route``): scores on the card
with no process group go to kernel 11 (``ops/sinkhorn_cuda.
sinkhorn_assignment_cuda``), which computes this form with all iterations
in one launch; with a process group, to kernel 11's cross-rank form
(``sinkhorn_assignment_dp_cuda``: a launch an iteration, the [K + 1] row
sums all-reduced between them); on the CPU the matvec form below runs. The JAX package retired its own kernel from dispatch because the
matvec form beat it on v5e, and wrote the rule: "don't re-dispatch without
beating the matvec numbers" (``timetuning_tpu/ops/sinkhorn_pallas.py:1-13``).
On the H100 the kernel beats the matvec form (PERF.md §6), so it is
dispatched on the card, in one process and across ranks. ``sinkhorn``
itself stays the matvec form on every device: it is the plain version of
both forms.

Everything is f32. With a ``torch.distributed`` process group the three sums
that span the global batch (the total mass, the valid-sample count, the
per-prototype row sums) are all-reduced over it, as the JAX version psums
them over its mesh axis.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    import torch.distributed as dist

    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def sinkhorn(Q: torch.Tensor, n_iters: int = 3, group=None,
             world_size: int = 1,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Doubly-stochastic normalisation of a transport matrix.

    Q: [K, B] non-negative scores (``exp(scores / eps).T``), K prototypes and
    B samples. ``world_size`` sets the column marginal ``1 / (B * world)``;
    ``valid`` [B] (1 = real sample, 0 = padding) zeroes columns and removes
    them from every sum. Returns [B, K]: every valid row sums to 1 and the
    prototype masses are balanced over the (global) batch.

    A marginal that is exactly zero (a masked column, a prototype row that
    underflowed) is pinned to 0 instead of compounding ``r / eps`` into inf:
    its scaling can never matter, and 0 * inf would poison the result.
    """
    Q = Q.float()
    K, B = Q.shape
    if valid is not None:
        Q = Q * valid.float()[None, :]
    Q = Q / (_all_reduce(Q.sum(), group) + _EPS)

    r = 1.0 / K
    if valid is None:
        c = 1.0 / (B * world_size + _EPS)
    else:
        c = 1.0 / (_all_reduce(valid.float().sum(), group) + _EPS)

    a = torch.ones(K, dtype=torch.float32, device=Q.device)
    b = torch.ones(B, dtype=torch.float32, device=Q.device)
    zero = torch.zeros((), dtype=torch.float32, device=Q.device)
    Qt = Q.t()
    for _ in range(n_iters):
        u = a * _all_reduce(torch.mv(Q, b), group)              # [K]
        a = torch.where(u > 0, a * (r / (u + _EPS)), zero)
        col = b * torch.mv(Qt, a)                               # [B], local
        b = torch.where(col > 0, b * (c / (col + _EPS)), zero)
    col = b * torch.mv(Qt, a)
    return (Q * a[:, None] * (b / (col + _EPS))[None, :]).t()


def sinkhorn_route(device: torch.device, group=None) -> str:
    """"kernel" for scores on a CUDA device with no process group,
    "kernel_dp" on a CUDA device with one, "matvec" on the CPU."""
    if device.type != "cuda":
        return "matvec"
    return "kernel" if group is None else "kernel_dp"


@torch.no_grad()
def sinkhorn_assignment(scores: torch.Tensor, epsilon: float = 0.05,
                        n_iters: int = 10, group=None, world_size: int = 1,
                        valid: torch.Tensor | None = None) -> torch.Tensor:
    """``find_optimal_assignment`` (reference time_tuning.py:157-168):
    scores [B, K] -> ``sinkhorn(exp(scores / eps).T)`` [B, K]. The assignment
    is a soft label, not a differentiable path: no gradient. On the card:
    kernel 11, in one launch with no ``group``, across the ranks of
    ``group`` with one (``sinkhorn_route``)."""
    route = sinkhorn_route(scores.device, group)
    if route != "matvec":
        from timetuning_tpu_torch.ops import sinkhorn_cuda  # imports this module

        if route == "kernel":
            return sinkhorn_cuda.sinkhorn_assignment_cuda(
                scores, epsilon, n_iters, valid=valid, world_size=world_size)
        return sinkhorn_cuda.sinkhorn_assignment_dp_cuda(
            scores, epsilon, n_iters, group=group, world_size=world_size,
            valid=valid)
    q = torch.exp(scores.detach() / epsilon).t()
    return sinkhorn(q, n_iters=n_iters, group=group, world_size=world_size,
                    valid=valid)
