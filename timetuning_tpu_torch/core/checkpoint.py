"""Checkpoint, resume and best-model export.

Counterpart of ``timetuning_tpu/core/checkpoint.py`` (reference
time_tuning.py:460-505: per-epoch saves of ``{epoch, global_step, model,
optimizer, scheduler}``, the most recent run directory found by its sorted
timestamp, and ``{score}_{epoch}.pth`` exports of the model state, :637-641).
Orbax's pytree checkpoint becomes one ``torch.save`` of state dicts, written
to a temporary file and renamed, so a crash mid-write leaves the previous
checkpoint whole.

What a checkpoint holds: the model's parameters, the optimizer's step count
and its AdamW moments keyed by parameter name (so a checkpoint written with
the optimizer over the trainable subtree loads into one over the full tree
and back: a frozen leaf gets no gradient and so no AdamW state), the EMA
teacher, the feature queue and its fill, the step and the
epoch. The ``checkpoint_meta.json`` sidecar has the JAX package's keys.
No generator state is saved: every step's randomness is a function of
(seed, step, rank) (core/train.step_generator).

Over a process group (the data axis) every rank calls ``save_checkpoint``:
the per-rank parts are gathered (each rank's queue into the [world x rows]
queue JAX saves; ZeRO-1's moment chunks into the padded flat vectors, in
the port's parameter order), rank 0 alone writes, and every rank returns
after the file is whole. Every rank reads a checkpoint; the optimizer state
is converted on load to the run's layout (by name or ZeRO-1, at any world
size: ``core/optimizer.migrate_*``).

On a 2-D mesh (tensor or expert parallelism: the model's
``param_sharding``) the parameters, the teacher and the AdamW moments are
gathered to the whole layout before rank 0 writes (a collective over the
model or expert axis), the global queue is saved as it is, and a load takes
each rank's slices: a TP checkpoint loads into one process, and a
one-process checkpoint into TP.
"""

from __future__ import annotations

import datetime
import json
import os
import re

import torch

CHECKPOINT = "checkpoint.pt"


def make_run_directory(base: str) -> str:
    """logs/YYYYMMDD/HHMMSS, the reference's layout (time_tuning.py:555-566)."""
    now = datetime.datetime.now()
    path = os.path.join(base, now.strftime("%Y%m%d"), now.strftime("%H%M%S"))
    os.makedirs(path, exist_ok=True)
    return path


def find_last_run_directory(base: str) -> str | None:
    """Most recent timestamped run dir (reference
    ``find_the_last_logging_directory``, time_tuning.py:473-491)."""
    if not os.path.isdir(base):
        return None
    days = sorted(d for d in os.listdir(base) if re.fullmatch(r"\d{8}", d))
    for day in reversed(days):
        times = sorted(t for t in os.listdir(os.path.join(base, day))
                       if re.fullmatch(r"\d{6}", t))
        if times:
            return os.path.join(base, day, times[-1])
    return None


def _atomic_write(path: str, write) -> None:
    tmp = os.path.join(os.path.dirname(path), "." + os.path.basename(path) + ".tmp")
    write(tmp)
    os.replace(tmp, path)


def _cpu(t):
    return None if t is None else t.detach().to("cpu", copy=True)


def _gather_chunks(v: torch.Tensor, opt, group) -> torch.Tensor:
    """A ZeRO-1 chunk of every rank as the [padded] vector, on the CPU."""
    from timetuning_tpu_torch.parallel.mesh import all_reduce_sum

    full = torch.zeros(opt.plan.padded, dtype=v.dtype, device=v.device)
    opt.chunk_of(full).copy_(v)
    if group is not None:
        full = all_reduce_sum(full, group)
    return full.cpu()


def _opt_payload(opt, group=None, sharding=None) -> dict:
    """The optimizer's step count and its AdamW state by parameter name (each
    moment gathered to the whole layout where ``sharding`` splits it), or
    ZeRO-1's padded flat moments gathered over the group."""
    from timetuning_tpu_torch.core.optimizer import Zero1Optimizer

    if isinstance(opt, Zero1Optimizer):
        return {"layout": "zero1", "count": opt.count,
                "mu": _gather_chunks(opt.mu, opt, group),
                "nu": _gather_chunks(opt.nu, opt, group),
                "decay_vec": opt.plan.decay_vec.clone()}
    state = {}
    for name, p in opt.named_params.items():
        st = opt.adamw.state.get(p)
        if st:
            state[name] = {
                k: _cpu(v if sharding is None or not v.dim() else sharding.gather(name, v))
                if torch.is_tensor(v) else v for k, v in st.items()}
    return {"count": opt.count, "state": state}


def _load_opt(opt, payload: dict, sharding=None) -> None:
    """Load an optimizer payload of either layout into ``opt``'s (each
    moment's slice where ``sharding`` splits it)."""
    from timetuning_tpu_torch.core.optimizer import (
        Zero1Optimizer,
        migrate_subtree_to_zero1,
        migrate_zero1_to_subtree,
        validate_zero1_fingerprint,
    )

    zero1 = payload.get("layout") == "zero1"
    if isinstance(opt, Zero1Optimizer):
        if zero1 and payload["mu"].shape[0] == opt.plan.padded:
            validate_zero1_fingerprint(payload["decay_vec"], opt.plan)
        else:
            if zero1:       # another world size: through the by-name layout
                payload = migrate_zero1_to_subtree(payload, opt.named_params,
                                                   opt.trainable_mask)
            payload = migrate_subtree_to_zero1(payload, opt.plan)
        opt.count = int(payload["count"])
        dev = opt.mu.device
        opt.mu = opt.chunk_of(payload["mu"]).to(dev, copy=True)
        opt.nu = opt.chunk_of(payload["nu"]).to(dev, copy=True)
        return
    if zero1:
        payload = migrate_zero1_to_subtree(payload, opt.named_params, opt.trainable_mask)
    opt.count = int(payload["count"])
    saved = payload["state"]
    opt.adamw.state.clear()
    for name, p in opt.named_params.items():
        # a leaf the saved optimizer did not track was frozen there: it gets
        # no gradient, so AdamW keeps no state for it here either
        if name in saved:
            opt.adamw.state[p] = {
                k: (v if sharding is None else sharding.local(name, v)).to(p.device)
                if torch.is_tensor(v) and v.dim() else v
                for k, v in saved[name].items()}


def save_checkpoint(state, run_dir: str, epoch: int, meta: dict | None = None,
                    group=None) -> str:
    """Write the whole ``TrainState`` and the epoch to
    ``run_dir/checkpoint.pt``, and ``meta`` (small, JSON-able) to
    ``checkpoint_meta.json`` beside it; both by temporary file and rename.
    With ``group`` every rank calls it, rank 0 writes, and all return once
    the files are in place."""
    from timetuning_tpu_torch.core.optimizer import Zero1Optimizer
    from timetuning_tpu_torch.parallel.mesh import (
        all_gather_rows,
        all_reduce_sum,
        data_rank,
        param_sharding,
    )

    run_dir = os.path.abspath(run_dir)
    path = os.path.join(run_dir, CHECKPOINT)
    writer = data_rank(group) == 0
    sharding = param_sharding(state.model)
    # the collectives first, on every rank
    queue = state.queue
    if queue is not None and group is not None and state.mesh is None:
        queue = all_gather_rows(queue, group)
    optimizer = model = teacher = None
    if writer or isinstance(state.opt, Zero1Optimizer) or sharding is not None:
        optimizer = _opt_payload(state.opt, group, sharding)
    if writer or sharding is not None:
        model = state.model.state_dict()
        teacher = state.teacher
        if sharding is not None:
            model = sharding.gather_state_dict(model)
            teacher = None if teacher is None else sharding.gather_state_dict(teacher)
    if writer:
        payload = {
            "epoch": int(epoch),
            "step": int(state.step),
            "model": {k: _cpu(v) for k, v in model.items()},
            "optimizer": optimizer,
            "teacher": (None if teacher is None
                        else {k: _cpu(v) for k, v in teacher.items()}),
            "queue": _cpu(queue),
            "queue_fill": int(state.queue_fill),
        }
        _atomic_write(path, lambda tmp: torch.save(payload, tmp))
        if meta is not None:
            def write_meta(tmp):
                with open(tmp, "w") as f:
                    json.dump(meta, f)
            _atomic_write(os.path.join(run_dir, "checkpoint_meta.json"), write_meta)
    if group is not None:   # a barrier: the file is whole before any rank reads it
        all_reduce_sum(torch.zeros(1, device=state.model.prototypes.device), group)
    return path


def load_checkpoint_meta(run_dir: str) -> dict | None:
    """The ``checkpoint_meta.json`` sidecar, or None."""
    p = os.path.join(os.path.abspath(run_dir), "checkpoint_meta.json")
    if not os.path.exists(p):
        return None
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def saved_zero1_padding(run_dir: str) -> int | None:
    """The padded length of a checkpoint's ZeRO-1 moments, or None when
    there is no checkpoint or its optimizer state is by name."""
    path = os.path.join(os.path.abspath(run_dir), CHECKPOINT)
    if not os.path.exists(path):
        return None
    opt = torch.load(path, map_location="cpu", weights_only=True, mmap=True)["optimizer"]
    return int(opt["mu"].shape[0]) if opt.get("layout") == "zero1" else None


def load_checkpoint(run_dir: str, state):
    """Restore ``state`` in place from ``run_dir``; returns (state, epoch), and
    (state, 0) when there is no checkpoint (the reference's tolerant resume,
    time_tuning.py:503-505). The queue is restored as saved (all ranks'
    rows); the caller checks its partition against the run's and takes its
    rank's rows."""
    path = os.path.join(os.path.abspath(run_dir), CHECKPOINT)
    if not os.path.exists(path):
        return state, 0
    from timetuning_tpu_torch.parallel.mesh import param_sharding

    payload = torch.load(path, map_location="cpu", weights_only=True)
    sharding = param_sharding(state.model)
    model = payload["model"]
    if sharding is not None:
        model = sharding.local_state_dict(model)
    state.model.load_state_dict(model)
    _load_opt(state.opt, payload["optimizer"], sharding)
    if state.teacher is not None:
        saved = payload["teacher"] or {}
        student = state.model.state_dict()
        with torch.no_grad():
            for name, t in state.teacher.items():
                # a leaf the saved teacher shared with the student
                if name not in saved:
                    t.copy_(student[name])
                else:
                    t.copy_(saved[name] if sharding is None
                            else sharding.local(name, saved[name]))
    if payload["queue"] is not None:
        dev = state.model.prototypes.device
        state.queue = payload["queue"].to(dev)
    state.queue_fill = int(payload["queue_fill"])
    state.step = int(payload["step"])
    return state, int(payload["epoch"])


def export_best(model: torch.nn.Module, run_dir: str, score: float,
                epoch: int) -> str:
    """The model alone as ``{score:.4f}_{epoch}.pth`` in the published
    TimeT.pth key layout (README.md:66-76; time_tuning.py:637-641), so it
    loads into the reference code. The port's module names differ from that
    layout only in the head's ``lin{i}`` (the reference's Sequential
    indices 2 i), which the exporter maps, through the JAX tree layout
    (models/convert.timet_params_to_jax, models/export_torch)."""
    from timetuning_tpu_torch.models.convert import timet_params_to_jax
    from timetuning_tpu_torch.models.export_torch import save_timet_pth

    path = os.path.join(os.path.abspath(run_dir), f"{score:.4f}_{epoch}.pth")
    save_timet_pth(timet_params_to_jax(model.state_dict()), path)
    return path


def import_timet_pth(path: str) -> dict[str, torch.Tensor]:
    """A published TimeT checkpoint as a state dict of the port's ``TimeT``
    (``feature_extractor.backbone.*``, ``feature_extractor.head.lin{i}.*``,
    ``prototypes``)."""
    from timetuning_tpu_torch.models.convert import timet_state_dict_from_jax
    from timetuning_tpu_torch.models.import_torch import (
        load_torch_state_dict,
        timet_params_from_torch,
    )

    return timet_state_dict_from_jax(timet_params_from_torch(load_torch_state_dict(path)))
