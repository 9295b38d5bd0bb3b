"""The data axis: one process per device over ``torch.distributed``.

Counterpart of ``timetuning_tpu/parallel/mesh.py``. The JAX package runs one
process with a ``Mesh(('data',))`` over its devices and shard_maps the step
over it: the batch sharded, the state replicated, collectives over the axis
by name. The port runs one process per device, the reference's own layout
(DDP over NCCL, time_tuning.py:516-521, 715-717): each process holds the
same replicated state, its own slice of the batch, and the default process
group of ``torch.distributed``, which is what ``TimeTConfig.axis_name``
names. The caller initializes the group (``init_from_env`` does it from
``torchrun``'s environment); the library takes it as it finds it, with the
backend the caller chose.

Every collective of the port is an ``all_reduce`` or a ``broadcast``: gloo
and NCCL both take these on CUDA and CPU tensors, where gloo's
``reduce_scatter`` / ``all_gather`` support varies by device. A
reduce-scatter is an all-reduce and a slice, an all-gather the all-reduce
of a zero-scattered buffer (JAX's own ZeRO-1 rebuild,
``timetuning_tpu/core/timet.py:640-659``).
"""

from __future__ import annotations

import datetime
import os

import torch

DATA_AXIS = "data"

# the slice that ports the (data, model) and (data, seq) meshes
TP_SP_PP_ITEM = "ROADMAP.md queue 1 item 11c, 'tp, sp and pp'"


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def data_group(axis_name: str | None):
    """The process group of the data axis ``axis_name``: the default group
    (``torch.distributed.group.WORLD``), which must be initialized; None
    for no axis (one process)."""
    if axis_name is None:
        return None
    if not is_initialized():
        raise RuntimeError(
            f"axis_name={axis_name!r} needs an initialized torch.distributed "
            "process group (init_process_group, or parallel.mesh.init_from_env "
            "under torchrun)")
    return _dist().group.WORLD


def data_rank(group=None) -> int:
    """This process's index on the data axis (0 with no group)."""
    if group is None and not is_initialized():
        return 0
    return _dist().get_rank(group)


def data_world_size(group=None) -> int:
    """Processes on the data axis (1 with no group)."""
    if group is None and not is_initialized():
        return 1
    return _dist().get_world_size(group)


def init_from_env(device: str | torch.device | None = None,
                  timeout_s: float = 1800.0) -> torch.device:
    """Initialize the default group from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; the counterpart of
    ``jax.distributed.initialize()``) and return this process's device:
    ``device`` when given (``"cpu"``), else ``cuda:LOCAL_RANK``. The backend
    is NCCL for the card and gloo for the CPU."""
    dist = _dist()
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found (torch.cuda.is_available() is false); "
                "pass --device cpu to run the ranks on the host")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo", init_method="env://",
            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``psum``: a new tensor, the sum of ``x`` over the group."""
    x = x.clone()
    _dist().all_reduce(x, op=_dist().ReduceOp.SUM, group=group)
    return x


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """``pmean``: the sum over the group divided by its size."""
    return all_reduce_sum(x, group) / data_world_size(group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``all_gather`` + reshape: [n, ...] a rank -> [world * n, ...], rank r's
    rows at r * n, as the all-reduce of a zero-scattered buffer."""
    world, rank = data_world_size(group), data_rank(group)
    n = x.shape[0]
    buf = x.new_zeros((world * n, *x.shape[1:]))
    buf[rank * n:(rank + 1) * n] = x
    return all_reduce_sum(buf, group)


def broadcast_tensors(tensors, group, src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s values: the
    replicated state (parameters, teacher, prototypes) starts equal on
    every rank."""
    dist = _dist()
    for t in tensors:
        dist.broadcast(t.data, src=src, group=group)


def shard_batch(batch, device, group=None):
    """Rank r's slice of a host batch that holds the GLOBAL batch along its
    leading axis (``shard_batch`` / ``batch_sharding`` on a mesh), on
    ``device``. A loader that already yields the rank's own batch (the
    driver's ``rank::world`` striding) needs no slicing: its batch goes to
    the device whole (``data/loader.host_batch_to_device``)."""
    world, rank = data_world_size(group), data_rank(group)

    def one(x):
        t = torch.as_tensor(x)
        if t.shape[0] % world:
            raise ValueError(f"a batch of {t.shape[0]} does not split over "
                             f"{world} ranks")
        n = t.shape[0] // world
        return t[rank * n:(rank + 1) * n].to(device)

    if isinstance(batch, (tuple, list)):
        return type(batch)(one(x) for x in batch)
    return one(batch)


def make_2d_mesh(n_outer: int, n_inner: int, axis_names: tuple[str, str],
                 devices=None):
    """The (data, model) and (data, seq) meshes: not ported yet."""
    raise NotImplementedError(
        f"make_2d_mesh{axis_names}: the 2-D meshes of tensor, sequence and "
        f"pipeline parallelism are not ported yet ({TP_SP_PP_ITEM})")
