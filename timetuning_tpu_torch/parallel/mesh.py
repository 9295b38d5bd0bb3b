"""The data axis, and the 2-D meshes, over ``torch.distributed``.

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

The 2-D meshes (``make_2d_mesh``: the ``(data, model)``, ``(data,
expert)``, ``(data, seq)`` and ``(data, pipe)`` meshes of parallel/tp,
parallel/ep, parallel/sp and parallel/pp) are process groups: the inner axis
a group of consecutive ranks, the outer axis a group of the ranks at one
inner index. JAX jits one GSPMD or shard_map program over such a mesh; here
the modules place the collectives by hand, with the conjugate pair
``copy_to_group`` (identity forward, all-reduce backward) and
``reduce_from_group`` (all-reduce forward, identity backward), and
``all_gather_along`` (all-reduce both ways: sequence parallelism's keys and
values, which each rank reads with its own queries). A parameter that a rank holds a slice of is described
by a ``ShardSpec`` (``ParamSharding`` gathers and slices whole state dicts).
While ``torch.export`` traces, the all-reduce is the functional collective
(``_c10d_functional.all_reduce`` on the group's name), and the autograd
Functions step aside where no gradient is wanted.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Mapping, NamedTuple

import torch

DATA_AXIS = "data"


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
    """``psum``: a new tensor, the sum of ``x`` over the group. While
    ``torch.export`` traces, the functional collective, so the program holds
    it as ``_c10d_functional.all_reduce`` on the group's name."""
    if torch.compiler.is_exporting():
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(
            x, "sum", _dist().group.WORLD if group is None else group))
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


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A 2-D mesh of ranks: ``shape`` maps the two axis names to their sizes
    (JAX's ``Mesh.shape``); ``outer`` and ``inner`` are this rank's process
    groups along each axis (None where the axis has size 1: no collective),
    ``coords`` its (outer, inner) indices, None for a rank off the mesh;
    ``grid[o][i]`` is the global rank at (o, i)."""

    axis_names: tuple
    shape: dict
    outer: object
    inner: object
    coords: tuple | None
    grid: tuple

    @property
    def n_outer(self) -> int:
        return self.shape[self.axis_names[0]]

    @property
    def n_inner(self) -> int:
        return self.shape[self.axis_names[1]]

    @property
    def outer_index(self) -> int:
        return self.coords[0]

    @property
    def inner_index(self) -> int:
        return self.coords[1]

    def broadcast_from_origin(self, t: torch.Tensor) -> None:
        """Overwrite ``t`` in place with its value at mesh coordinates
        (0, 0): a broadcast along the inner axis from inner index 0, then
        along the outer axis from outer index 0 (every rank of the mesh
        calls it)."""
        o, i = self.coords
        if self.inner is not None:
            _dist().broadcast(t, src=self.grid[o][0], group=self.inner)
        if self.outer is not None:
            _dist().broadcast(t, src=self.grid[0][i], group=self.outer)


def make_2d_mesh(n_outer: int, n_inner: int, axis_names: tuple[str, str],
                 devices=None) -> Mesh2D:
    """The 2-D mesh behind the (data, model), (data, expert), (data, seq)
    and (data, pipe) meshes, with the INNER axis over consecutive ranks
    (JAX's grid puts it innermost).
    ``devices``: the global ranks to lay out (default all); the first
    ``n_outer * n_inner`` of them form the grid, and a rank past them gets
    ``coords=None``. Every rank of the default group must call it, in the
    same order (``torch.distributed.new_group``). Raises where JAX raises:
    more ranks asked for than there are."""
    world = data_world_size() if is_initialized() else 1
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if n_outer * n_inner > len(ranks):
        raise ValueError(
            f"{axis_names[0]}*{axis_names[1]}={n_outer * n_inner} exceeds "
            f"{len(ranks)} devices")
    grid = [ranks[o * n_inner:(o + 1) * n_inner] for o in range(n_outer)]
    me = data_rank() if is_initialized() else 0
    outer = inner = coords = None
    for o, row in enumerate(grid):
        g = _dist().new_group(row) if n_inner > 1 else None
        if me in row:
            inner, coords = g, (o, row.index(me))
    for i in range(n_inner):
        col = [row[i] for row in grid]
        g = _dist().new_group(col) if n_outer > 1 else None
        if me in col:
            outer = g
    return Mesh2D(tuple(axis_names), {axis_names[0]: n_outer, axis_names[1]: n_inner},
                  outer, inner, coords, tuple(tuple(row) for row in grid))


def _sum_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The all-reduce of the conjugate pair, in f32 whatever ``x``'s dtype
    (the result is the same bits on every rank)."""
    return all_reduce_sum(x.float(), group).to(x.dtype)


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumVarying(torch.autograd.Function):
    """The all-reduce whose result each rank uses in its own way (the
    transpose of a device-varying ``psum``): the cotangents differ by rank,
    so the backward sums them too. In ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Where a replicated activation enters a computation that each rank of
    ``group`` does a part of: identity forward, all-reduce of the gradient
    backward (Megatron's f). A no-op without a group."""
    return x if group is None or not _needs_grad(x) else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' partial results: all-reduce forward, identity
    backward (Megatron's g). A no-op without a group."""
    if group is None:
        return x
    return _ReduceFromGroup.apply(x, group) if _needs_grad(x) else _sum_f32(x, group)


def _zero_scattered(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.zeros_like(x) for _ in range(data_world_size(group))]
    parts[data_rank(group)] = x
    return torch.cat(parts, dim)


def gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' slices of ``dim`` side by side in the group's rank order:
    the all-reduce of a zero-scattered buffer, differentiable (the backward
    hands each rank the gradient of its own slice), for a result that
    everything downstream uses alike on every rank. A no-op without a
    group."""
    if group is None:
        return x
    return reduce_from_group(_zero_scattered(x, dim, group), group)


def all_gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)`` along ``dim``: the ranks' slices
    side by side in the group's rank order, for a result that each rank uses
    in its own way (sequence parallelism's keys and values, read by every
    rank's own queries). Its backward is JAX's transpose, a reduce-scatter:
    the gradients of all the ranks summed, then this rank's slice.
    ``gather_along``'s backward keeps only this rank's own gradient. A
    no-op without a group."""
    if group is None:
        return x
    buf = _zero_scattered(x, dim, group)
    return _SumVarying.apply(buf, group) if _needs_grad(buf) else all_reduce_sum(buf, group)


class ShardSpec(NamedTuple):
    """How a rank's slice of a parameter lies in the whole: the whole's
    ``dim`` holds ``parts`` equal blocks (3 for a fused q, k, v projection),
    and each block splits into equal contiguous slices, one a rank."""

    dim: int
    parts: int = 1


def local_slice(full: torch.Tensor, spec: ShardSpec, index: int, size: int) -> torch.Tensor:
    """Rank ``index``'s slice of the whole tensor ``full``."""
    blocks = full.chunk(spec.parts, spec.dim)
    return torch.cat([b.chunk(size, spec.dim)[index] for b in blocks], spec.dim)


def gather_slices(local: torch.Tensor, spec: ShardSpec, group, index: int,
                  size: int) -> torch.Tensor:
    """The whole tensor from every rank's slice (a collective over
    ``group``; without one the slice is the whole)."""
    if group is None:
        return local
    shape = list(local.shape)
    shape[spec.dim] *= size
    full = local.new_zeros(shape)
    n = local.shape[spec.dim] // spec.parts
    for p, piece in enumerate(local.chunk(spec.parts, spec.dim)):
        full.narrow(spec.dim, (p * size + index) * n, n).copy_(piece)
    return all_reduce_sum(full, group)


@dataclasses.dataclass
class ParamSharding:
    """The parameters of a module that this rank holds a slice of: ``specs``
    maps their names (as ``named_parameters()`` gives them, or any suffix
    of the form ``prefix.name``) to a ``ShardSpec``; the slices are over
    ``group`` (the mesh's inner axis), this rank's at ``index`` of
    ``size``."""

    specs: dict
    group: object
    index: int
    size: int

    def spec_of(self, name: str) -> ShardSpec | None:
        for n, spec in self.specs.items():
            if name == n or name.endswith("." + n):
                return spec
        return None

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        spec = self.spec_of(name)
        return full if spec is None else local_slice(full, spec, self.index, self.size)

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        spec = self.spec_of(name)
        return local if spec is None else gather_slices(
            local, spec, self.group, self.index, self.size)

    def local_state_dict(self, full: Mapping[str, torch.Tensor]) -> dict:
        return {k: self.local(k, v) for k, v in full.items()}

    def gather_state_dict(self, local: Mapping[str, torch.Tensor]) -> dict:
        """A collective: every rank of ``group`` calls it, in the same order."""
        return {k: self.gather(k, v) for k, v in local.items()}


def shard_module(module: torch.nn.Module, specs: Mapping[str, ShardSpec],
                 mesh: Mesh2D) -> ParamSharding:
    """Replace each parameter of ``module`` named in ``specs`` by this rank's
    slice along the mesh's inner axis (the same ``Parameter`` objects, new
    data) and record the sharding as ``module.param_sharding``. Build the
    optimizer after this."""
    sharding = ParamSharding(dict(specs), mesh.inner, mesh.inner_index, mesh.n_inner)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name in specs:
                p.data = sharding.local(name, p.data).clone()
    module.param_sharding = sharding
    return sharding


def param_sharding(module: torch.nn.Module) -> ParamSharding | None:
    """The sharding ``shard_module`` recorded on ``module``, or None."""
    return getattr(module, "param_sharding", None)
