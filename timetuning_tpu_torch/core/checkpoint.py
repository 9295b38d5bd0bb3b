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
(seed, step) (core/train.step_generator).
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


def _opt_payload(opt) -> dict:
    """The optimizer's step count and its AdamW state by parameter name."""
    state = {}
    for name, p in opt.named_params.items():
        st = opt.adamw.state.get(p)
        if st:
            state[name] = {k: _cpu(v) if torch.is_tensor(v) else v
                           for k, v in st.items()}
    return {"count": opt.count, "state": state}


def _load_opt(opt, payload: dict) -> None:
    opt.count = int(payload["count"])
    saved = payload["state"]
    opt.adamw.state.clear()
    for name, p in opt.named_params.items():
        # a leaf the saved optimizer did not track was frozen there: it gets
        # no gradient, so AdamW keeps no state for it here either
        if name in saved:
            opt.adamw.state[p] = {
                k: v.to(p.device) if torch.is_tensor(v) and v.dim() else v
                for k, v in saved[name].items()}


def save_checkpoint(state, run_dir: str, epoch: int, meta: dict | None = None) -> str:
    """Write the whole ``TrainState`` and the epoch to
    ``run_dir/checkpoint.pt``, and ``meta`` (small, JSON-able) to
    ``checkpoint_meta.json`` beside it; both by temporary file and rename."""
    run_dir = os.path.abspath(run_dir)
    path = os.path.join(run_dir, CHECKPOINT)
    payload = {
        "epoch": int(epoch),
        "step": int(state.step),
        "model": {k: _cpu(v) for k, v in state.model.state_dict().items()},
        "optimizer": _opt_payload(state.opt),
        "teacher": (None if state.teacher is None
                    else {k: _cpu(v) for k, v in state.teacher.items()}),
        "queue": _cpu(state.queue),
        "queue_fill": int(state.queue_fill),
    }
    _atomic_write(path, lambda tmp: torch.save(payload, tmp))
    if meta is not None:
        def write_meta(tmp):
            with open(tmp, "w") as f:
                json.dump(meta, f)
        _atomic_write(os.path.join(run_dir, "checkpoint_meta.json"), write_meta)
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


def load_checkpoint(run_dir: str, state):
    """Restore ``state`` in place from ``run_dir``; returns (state, epoch), and
    (state, 0) when there is no checkpoint (the reference's tolerant resume,
    time_tuning.py:503-505). The queue is restored as saved; the caller
    checks its partition against the run's."""
    path = os.path.join(os.path.abspath(run_dir), CHECKPOINT)
    if not os.path.exists(path):
        return state, 0
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    _load_opt(state.opt, payload["optimizer"])
    if state.teacher is not None:
        saved = payload["teacher"] or {}
        student = state.model.state_dict()
        with torch.no_grad():
            for name, t in state.teacher.items():
                # a leaf the saved teacher shared with the student
                t.copy_(saved[name] if name in saved else student[name])
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
