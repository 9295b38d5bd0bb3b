"""The materialising Sinkhorn kernel (csrc/sinkhorn.cu) and its plain version.

Counterpart of ``timetuning_tpu/ops/sinkhorn_pallas.py``: all iterations in
one launch on a matrix that stays on the chip. Like its TPU original it is
on no dispatched path: the train step's assignment is the diagonal-scaling
form of ``ops/sinkhorn.py``. Semantics are ``ops.sinkhorn.sinkhorn`` with no
process group and ``world_size=1``, except at zero marginals: this form
divides an all-zero row or column by 1e-12 where the other pins it, so the
two agree wherever no row or column of Q underflows.
"""

from __future__ import annotations

import ctypes

import torch

from timetuning_tpu_torch.ops import kernel_lib

_EPS = 1e-12


def sinkhorn_plain(Q: torch.Tensor, n_iters: int = 3,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: the materialising loop of ``_iterate_inplace``
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


def sinkhorn_cuda(Q: torch.Tensor, n_iters: int = 3,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel 11. Q: [K, B] non-negative, ``valid``: optional [B] mask.
    Returns [B, K] f32. No backward: the assignment is a label."""
    kernel_lib.require_no_grad("sinkhorn_cuda", Q, valid)
    if Q.device.type == "cpu":
        return sinkhorn_plain(Q, n_iters, valid)
    if Q.dim() != 2 or (valid is not None and tuple(valid.shape) != (Q.shape[1],)):
        raise ValueError(f"sinkhorn_cuda: expected Q [K, B] and valid [B], got "
                         f"{tuple(Q.shape)}, "
                         f"{None if valid is None else tuple(valid.shape)}")
    K, B = Q.shape
    Q = Q.detach().float().contiguous()
    tensors = [Q]
    if valid is not None:
        valid = valid.detach().float().contiguous()
        tensors.append(valid)
    kernel_lib.require_cuda("sinkhorn_cuda", *tensors)
    with torch.cuda.device(Q.device):
        plan = (ctypes.c_int * 3)()
        err = kernel_lib.library().tt_sinkhorn_plan(K, B, plan)
    if err != 0:
        raise RuntimeError(f"sinkhorn_cuda: no launch plan for a [{K}, {B}] "
                           f"matrix ({K * B * 4} bytes): CUDA error {err}")
    _, in_smem, n_blocks = plan
    part = torch.empty((2 * K + 2) * n_blocks, dtype=torch.float32,
                       device=Q.device)
    work = None if in_smem else torch.empty_like(Q)
    out = torch.empty((B, K), dtype=torch.float32, device=Q.device)
    kernel_lib.launch(
        "sinkhorn", "tt_sinkhorn", Q.device, Q.data_ptr(),
        None if valid is None else valid.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), part.data_ptr(), K, B,
        int(n_iters))
    return out
