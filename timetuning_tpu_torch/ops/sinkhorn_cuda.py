"""The Sinkhorn kernel (csrc/sinkhorn.cu), its plan and its plain versions.

Counterpart of ``timetuning_tpu/ops/sinkhorn_pallas.py``: all iterations in
one launch on a matrix that stays on the chip. The kernel computes
``ops.sinkhorn.sinkhorn`` with no process group, the diagonal-scaling form
with zero marginals pinned to 0, which is the function the TPU kernel's
docstring names; that function is its plain version. Two entries:
``sinkhorn_cuda`` on Q [K, B] and ``sinkhorn_assignment_cuda`` on the train
step's scores [B, K], which takes ``exp(scores / epsilon)`` as it loads.

Across ranks (a process group spans the batch),
``sinkhorn_assignment_dp_cuda`` runs the same iteration on the step's scores
as a chain of launches with an all-reduce of one [K + 1] vector between them (no
collective can run inside the one-launch form's grid barrier); their plain
version is ``ops.sinkhorn.sinkhorn`` with the group.

Dispatch: the JAX package retired its kernel from dispatch because the
matvec form beat it on v5e, with the rule "don't re-dispatch without beating
the matvec numbers" (``timetuning_tpu/ops/sinkhorn_pallas.py:1-13``). On the
H100 the kernel beats the matvec form (PERF.md §6), so
``ops.sinkhorn.sinkhorn_assignment`` takes ``sinkhorn_assignment_cuda`` for
scores on the card with no process group and ``sinkhorn_assignment_dp_cuda``
with one; on the CPU the matvec form runs.

``sinkhorn_plain`` is the TPU kernel's own materialising loop, kept as that
kernel's reference (tests pin it in interpret mode): it divides an all-zero
row or column by 1e-12 where the matvec form pins it, and agrees with it
wherever no row or column of Q underflows.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from timetuning_tpu_torch.ops import kernel_lib
from timetuning_tpu_torch.ops import sinkhorn as _matvec

_EPS = 1e-12
_THREADS = 512              # csrc/sinkhorn.cu kThreads
_WARPS = _THREADS // 32
_CLUSTER = 8                # blocks of a thread block cluster
_MIN_COLS = 16              # columns a block at least
_MAX_SMEM = 232448          # bytes of shared memory a block may use
_MAX_K = 1024


def sinkhorn_plain(Q: torch.Tensor, n_iters: int = 3,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """The TPU kernel's materialising loop, ``_iterate_inplace``
    (``timetuning_tpu/ops/sinkhorn_pallas.py:33-48``). Q [K, B] -> [B, K]."""
    Q = Q.float()
    K, B = Q.shape
    if valid is None:
        c = 1.0 / B
    else:
        Q = Q * valid.float()[None, :]
        c = 1.0 / (valid.float().sum() + _EPS)
    r = 1.0 / K
    Q = Q / (Q.sum() + _EPS)
    for _ in range(n_iters):
        Q = Q * (r / (Q.sum(dim=1, keepdim=True) + _EPS))
        Q = Q * (c / (Q.sum(dim=0, keepdim=True) + _EPS))
    return (Q / (Q.sum(dim=0, keepdim=True) + _EPS)).t()


@dataclasses.dataclass(frozen=True)
class SinkhornPlan:
    """How ``csrc/sinkhorn.cu`` places a [K, B] matrix: ``blocks`` blocks
    of ``cols`` columns in ``clusters`` clusters of 8, the slabs in shared
    memory (``in_smem``) or in the output, ``smem`` dynamic bytes a block."""

    cols: int
    in_smem: bool
    blocks: int
    clusters: int
    smem: int


def smem_bytes(K: int, cols: int, in_smem: bool) -> int:
    """The kernel's dynamic shared memory (``layout`` in csrc/sinkhorn.cu):
    the warps' row partials, the block's, a, b and, in shared memory, the
    slab [cols, K | 1]."""
    K1 = K + 1
    floats = _WARPS * K1 + K1 + K + cols + (cols * (K | 1) if in_smem else 0)
    return floats * 4


def sinkhorn_plan(K: int, B: int, max_clusters: int) -> SinkhornPlan:
    """The kernel's plan (``make_plan`` in csrc/sinkhorn.cu) on a card where
    ``max_clusters`` clusters of 8 blocks can be resident with one block an
    SM (``cudaOccupancyMaxActiveClusters``; 15 on an H100 SXM). The columns
    are spread over those blocks, at least 16 a block; the slabs stay in
    shared memory where they fit. Raises where no plan fits."""
    if not 0 < K <= _MAX_K or B <= 0 or K * B > 0x7FFFFFFF:
        raise ValueError(f"sinkhorn_cuda: no plan for a [{K}, {B}] matrix (the "
                         f"kernel takes 1 <= K <= {_MAX_K})")
    cap = max_clusters * _CLUSTER
    cols = max(_MIN_COLS, -(-B // cap))
    in_smem = smem_bytes(K, cols, True) <= _MAX_SMEM
    smem = smem_bytes(K, cols, in_smem)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"sinkhorn_cuda: a [{K}, {B}] matrix needs {smem} bytes of shared "
            f"memory a block even with its slabs in device memory (at most "
            f"{_MAX_SMEM})")
    blocks = -(-(-(-B // cols)) // _CLUSTER) * _CLUSTER
    return SinkhornPlan(cols, in_smem, blocks, blocks // _CLUSTER, smem)


def device_plan(K: int, B: int, device=None) -> tuple[SinkhornPlan, int]:
    """The C side's plan on ``device`` and its count of resident clusters
    (the card's tests hold it to ``sinkhorn_plan``)."""
    with torch.cuda.device(device):
        out = (ctypes.c_int * 6)()
        err = kernel_lib.library().tt_sinkhorn_plan(K, B, out)
    if err != 0:
        raise RuntimeError(f"sinkhorn_cuda: no launch plan for a [{K}, {B}] "
                           f"matrix: CUDA error {err}")
    cols, in_smem, blocks, clusters, max_clusters, smem = out
    return SinkhornPlan(cols, bool(in_smem), blocks, clusters, smem), max_clusters


def _launch(src, from_scores: bool, K: int, B: int, n_iters: int, epsilon: float,
            valid, world_size: int) -> torch.Tensor:
    tensors = [src] if valid is None else [src, valid]
    kernel_lib.require_cuda("sinkhorn_cuda", *tensors)
    if valid is not None and tuple(valid.shape) != (B,):
        raise ValueError(f"sinkhorn_cuda: valid must be [{B}], got {tuple(valid.shape)}")
    if n_iters < 0:
        raise ValueError(f"sinkhorn_cuda: n_iters must be >= 0, got {n_iters}")
    if not 0 < K <= _MAX_K:
        raise ValueError(f"sinkhorn_cuda: the kernel takes 1 <= K <= {_MAX_K}, got {K}")
    plan, _ = device_plan(K, B, src.device)
    part = torch.zeros(2 * plan.clusters * (K + 1) + 1, dtype=torch.float32,
                       device=src.device)
    out = torch.empty((B, K), dtype=torch.float32, device=src.device)
    kernel_lib.launch(
        "sinkhorn", "tt_sinkhorn", src.device, src.data_ptr(),
        None if valid is None else valid.data_ptr(), out.data_ptr(),
        part.data_ptr(), K, B, int(n_iters), int(from_scores), float(epsilon),
        1.0 / (B * world_size + _EPS))
    return out


def sinkhorn_cuda(Q: torch.Tensor, n_iters: int = 3,
                  valid: torch.Tensor | None = None,
                  world_size: int = 1) -> torch.Tensor:
    """Kernel 11 on Q [K, B] non-negative, ``valid``: optional [B] mask.
    Returns [B, K] f32, ``ops.sinkhorn.sinkhorn(Q, n_iters, None,
    world_size, valid)``. No backward: the assignment is a label."""
    kernel_lib.require_no_grad("sinkhorn_cuda", Q, valid)
    if Q.device.type == "cpu":
        return _matvec.sinkhorn(Q, n_iters, world_size=world_size, valid=valid)
    if Q.dim() != 2:
        raise ValueError(f"sinkhorn_cuda: expected Q [K, B], got {tuple(Q.shape)}")
    K, B = Q.shape
    Q = Q.detach().float().contiguous()
    if valid is not None:
        valid = valid.detach().float().contiguous()
    return _launch(Q, False, K, B, n_iters, 1.0, valid, world_size)


def sinkhorn_assignment_cuda(scores: torch.Tensor, epsilon: float = 0.05,
                             n_iters: int = 10, valid: torch.Tensor | None = None,
                             world_size: int = 1) -> torch.Tensor:
    """Kernel 11 on the step's scores [B, K]: ``exp(scores / epsilon)`` taken
    as the kernel loads them, then the Sinkhorn of that [K, B] matrix.
    Returns [B, K] f32, ``ops.sinkhorn.sinkhorn_assignment`` with no process
    group, which is its plain version (the matvec form) on the CPU."""
    kernel_lib.require_no_grad("sinkhorn_assignment_cuda", scores, valid)
    if scores.device.type == "cpu":
        q = torch.exp(scores.detach().float() / epsilon).t()
        return _matvec.sinkhorn(q, n_iters, world_size=world_size, valid=valid)
    if scores.dim() != 2:
        raise ValueError(f"sinkhorn_assignment_cuda: expected scores [B, K], got "
                         f"{tuple(scores.shape)}")
    B, K = scores.shape
    s = scores.detach().float().contiguous()
    if valid is not None:
        valid = valid.detach().float().contiguous()
    return _launch(s, True, K, B, n_iters, epsilon, valid, world_size)


_DP_MIN_COLS = 16           # columns a block at least, cross-rank form
_DP_LOAD, _DP_ITER, _DP_LAST, _DP_OUT = range(4)   # csrc/sinkhorn.cu DpMode


def sinkhorn_dp_plan(B: int, sms: int) -> tuple[int, int]:
    """(columns a block, blocks) of the cross-rank form for B local columns
    on a card of ``sms`` SMs: one block an SM, at least 16 columns a block,
    no empty block (tt_sinkhorn_dp checks it)."""
    blocks = max(1, min(-(-B // _DP_MIN_COLS), sms))
    cols = -(-B // blocks)
    return cols, -(-B // cols)


def dp_launches(n_iters: int) -> int:
    """Launches of one cross-rank call: the load, then one an iteration (at
    least one, which writes the result)."""
    return 1 + max(n_iters, 1)


def _launch_dp(src, K: int, B: int, n_iters: int, epsilon: float, valid, group,
               world_size: int) -> torch.Tensor:
    name = "sinkhorn_assignment_dp_cuda"
    tensors = [src] if valid is None else [src, valid]
    kernel_lib.require_cuda(name, *tensors)
    if valid is not None and tuple(valid.shape) != (B,):
        raise ValueError(f"{name}: valid must be [{B}], got {tuple(valid.shape)}")
    if n_iters < 0:
        raise ValueError(f"{name}: n_iters must be >= 0, got {n_iters}")
    if not 0 < K <= _MAX_K:
        raise ValueError(f"{name}: the kernel takes 1 <= K <= {_MAX_K}, got {K}")
    if not epsilon > 0:
        raise ValueError(f"{name}: epsilon must be > 0, got {epsilon}")
    dev = src.device
    cols, blocks = sinkhorn_dp_plan(B, kernel_lib.sm_count(dev))
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((B, K), **f32)
    part = torch.empty(blocks * (K + 1), **f32)
    red = torch.empty(K + 1, **f32)
    avec = torch.empty(2 * K, **f32)
    scal = torch.empty(1, **f32)
    bvec = torch.empty(B, **f32)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    c = 1.0 / (B * world_size + _EPS)

    def launch(it: int, mode: int) -> None:
        kernel_lib.launch(
            "sinkhorn_dp", "tt_sinkhorn_dp", dev, src.data_ptr(),
            None if valid is None else valid.data_ptr(), out.data_ptr(),
            part.data_ptr(), red.data_ptr(), avec.data_ptr(), scal.data_ptr(),
            bvec.data_ptr(), counter.data_ptr(), K, B, cols, blocks, it, mode,
            float(epsilon), c)

    def all_reduce() -> None:
        if group is not None:
            import torch.distributed as dist

            dist.all_reduce(red, op=dist.ReduceOp.SUM, group=group)

    launch(0, _DP_LOAD)
    all_reduce()
    if n_iters == 0:
        launch(0, _DP_OUT)
    for it in range(n_iters):
        launch(it, _DP_LAST if it == n_iters - 1 else _DP_ITER)
        if it < n_iters - 1:
            all_reduce()
    return out


def sinkhorn_assignment_dp_cuda(scores: torch.Tensor, epsilon: float = 0.05,
                                n_iters: int = 10, group=None, world_size: int = 1,
                                valid: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel 11's cross-rank form on this rank's scores [B_local, K]:
    ``exp(scores / epsilon)`` taken as the load reads them, then the
    Sinkhorn over the group. Returns [B_local, K] f32,
    ``ops.sinkhorn.sinkhorn_assignment`` with the group, whose matvec form is
    its plain version (and what runs on CPU tensors)."""
    kernel_lib.require_no_grad("sinkhorn_assignment_dp_cuda", scores, valid)
    if scores.device.type == "cpu":
        q = torch.exp(scores.detach().float() / epsilon).t()
        return _matvec.sinkhorn(q, n_iters, group=group, world_size=world_size,
                                valid=valid)
    if scores.dim() != 2:
        raise ValueError(f"sinkhorn_assignment_dp_cuda: expected scores [B, K], "
                         f"got {tuple(scores.shape)}")
    B, K = scores.shape
    s = scores.detach().float().contiguous()
    if valid is not None:
        valid = valid.detach().float().contiguous()
    return _launch_dp(s, K, B, n_iters, epsilon, valid, group, world_size)
