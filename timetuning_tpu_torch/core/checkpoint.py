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

With a ``CheckpointWriter`` (the training driver's) the save returns once
the state is on the host, in host buffers the writer owns and reuses
(pinned for a card's tensors), and a thread of the writer's writes the
files while the caller steps on. The writer's ``join`` waits for that
write, raises what it raised, and over a process group is the barrier after
which every rank may read the file; the next save joins first.

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
import threading

import torch

from timetuning_tpu_torch.obs.profiling import annotate

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


def _map_tensors(tree, fn, path=()):
    """``tree`` (nested dicts) with each tensor ``t`` at key path ``path``
    replaced by ``fn(path, t)``."""
    if torch.is_tensor(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn, path + (k,)) for k, v in tree.items()}
    return tree


def _write_files(run_dir: str, payload: dict, meta_text: str | None) -> None:
    """``checkpoint.pt``, then ``checkpoint_meta.json``, each by temporary
    file and rename."""
    with annotate("save.write"):
        _atomic_write(os.path.join(run_dir, CHECKPOINT), lambda tmp: torch.save(payload, tmp))
        if meta_text is not None:
            def write_meta(tmp):
                with open(tmp, "w") as f:
                    f.write(meta_text)
            _atomic_write(os.path.join(run_dir, "checkpoint_meta.json"), write_meta)


class CheckpointWriter:
    """Writes each save's files from a thread of its own, at most one write
    in flight, from host buffers it keeps across saves: one a payload
    tensor, by its key path, allocated at the first save (pinned for a
    card's tensor) and filled again at each later one. A write's error is
    raised by the next ``join``. Every rank of a group keeps one; rank 0's
    writes."""

    def __init__(self):
        self._buffers: dict = {}
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._pending = False
        self._device = None

    def to_host(self, payload: dict) -> dict:
        """``payload`` with its tensors copied into the writer's buffers,
        after one wait for the copies: no later device work changes it."""
        buffers, cards = {}, set()

        def put(path, t):
            t = t.detach()
            b = self._buffers.get(path)
            if b is None or b.shape != t.shape or b.dtype != t.dtype:
                b = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            if t.is_cuda:
                cards.add(t.device)
            buffers[path] = b
            return b.copy_(t, non_blocking=True)

        host = _map_tensors(payload, put)
        self._buffers = buffers
        for dev in cards:
            torch.cuda.current_stream(dev).synchronize()
        return host

    def submit(self, write, device) -> None:
        """Start ``write`` (None on a rank that writes nothing) on the
        writer's thread; ``device``: the group's barrier tensor's."""
        self._pending, self._device = True, device
        if write is not None:
            self._thread = threading.Thread(target=self._run, args=(write,),
                                            name="checkpoint-writer", daemon=True)
            self._thread.start()

    def _run(self, write) -> None:
        try:
            write()
        except BaseException as e:   # raised on the main thread by the next join
            self._error = e

    def join(self, group=None) -> bool:
        """Wait for the write in flight and raise its error, if any. Over
        ``group`` every rank calls it, and all return once the files are
        whole: where rank 0's write failed, the other ranks raise too
        (without ``group``, as at the end of a run that raised, no
        collective). Whether the write was still running."""
        from timetuning_tpu_torch.parallel.mesh import all_reduce_sum

        if not self._pending:
            return False
        self._pending = False
        thread, self._thread = self._thread, None
        running = thread is not None and thread.is_alive()
        if thread is not None:
            thread.join()
        error, self._error = self._error, None
        if group is not None:   # a barrier: the file is whole before any rank reads it
            failed = all_reduce_sum(
                torch.tensor([float(error is not None)], device=self._device), group)
            if error is None and failed.item() > 0:
                raise RuntimeError("the checkpoint write on rank 0 failed")
        if error is not None:
            raise error
        return running


def _gather_chunks(v: torch.Tensor, opt, group) -> torch.Tensor:
    """A ZeRO-1 chunk of every rank as the [padded] vector."""
    from timetuning_tpu_torch.parallel.mesh import all_reduce_sum

    full = torch.zeros(opt.plan.padded, dtype=v.dtype, device=v.device)
    opt.chunk_of(full).copy_(v)
    if group is not None:
        full = all_reduce_sum(full, group)
    return full


def _opt_payload(opt, group=None, sharding=None) -> dict:
    """The optimizer's step count and its AdamW state by parameter name (each
    moment gathered to the whole layout where ``sharding`` splits it), or
    ZeRO-1's padded flat moments gathered over the group."""
    from timetuning_tpu_torch.core.optimizer import Zero1Optimizer

    if isinstance(opt, Zero1Optimizer):
        return {"layout": "zero1", "count": opt.count,
                "mu": _gather_chunks(opt.mu, opt, group),
                "nu": _gather_chunks(opt.nu, opt, group),
                "decay_vec": opt.plan.decay_vec}
    state = {}
    for name, p in opt.named_params.items():
        st = opt.adamw.state.get(p)
        if st:
            state[name] = {
                k: v if sharding is None or not torch.is_tensor(v) or not v.dim()
                else sharding.gather(name, v) for k, v in st.items()}
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
        # no gradient, so AdamW keeps no state for it here either; the
        # per-leaf "step" of earlier payloads is the count
        if name in saved:
            opt.adamw.state[p] = {
                k: (saved[name][k] if sharding is None
                    else sharding.local(name, saved[name][k])).to(p.device)
                for k in ("exp_avg", "exp_avg_sq")}


def save_checkpoint(state, run_dir: str, epoch: int, meta: dict | None = None,
                    group=None, writer: CheckpointWriter | None = None) -> str:
    """Write the whole ``TrainState`` and the epoch to
    ``run_dir/checkpoint.pt``, and ``meta`` (small, JSON-able) to
    ``checkpoint_meta.json`` beside it; both by temporary file and rename.
    With ``group`` every rank calls it, rank 0 writes, and all return once
    the files are in place. With ``writer`` it first joins the writer's
    previous write, and returns once the state and ``meta`` are copied to
    the host: the writer's thread writes the files, and its next ``join``
    is where they are whole."""
    from timetuning_tpu_torch.core.optimizer import Zero1Optimizer
    from timetuning_tpu_torch.parallel.mesh import (
        all_gather_rows,
        all_reduce_sum,
        data_rank,
        param_sharding,
    )

    run_dir = os.path.abspath(run_dir)
    writes = data_rank(group) == 0
    sharding = param_sharding(state.model)
    device = state.model.prototypes.device
    with annotate("train.save", epoch=int(epoch)):
        if writer is not None:
            with annotate("save.join") as span:
                waited = writer.join(group)
                if span is not None:
                    span.attrs["waited"] = waited
        # the collectives first, on every rank; then the state on the host
        with annotate("save.gather"):
            queue = state.queue
            if queue is not None and group is not None and state.mesh is None:
                queue = all_gather_rows(queue, group)
            optimizer = model = teacher = payload = None
            if writes or isinstance(state.opt, Zero1Optimizer) or sharding is not None:
                optimizer = _opt_payload(state.opt, group, sharding)
            if writes or sharding is not None:
                model = state.model.state_dict()
                teacher = state.teacher
                if sharding is not None:
                    model = sharding.gather_state_dict(model)
                    teacher = (None if teacher is None
                               else sharding.gather_state_dict(teacher))
            if writes:
                payload = {"epoch": int(epoch), "step": int(state.step), "model": model,
                           "optimizer": optimizer, "teacher": teacher, "queue": queue,
                           "queue_fill": int(state.queue_fill)}
                payload = (writer.to_host(payload) if writer is not None else
                           _map_tensors(payload, lambda _, t: t.detach().to("cpu", copy=True)))
                meta_text = None if meta is None else json.dumps(meta)
        if writer is not None:
            writer.submit((lambda: _write_files(run_dir, payload, meta_text)) if writes
                          else None, device)
        else:
            if writes:
                _write_files(run_dir, payload, meta_text)
            if group is not None:   # a barrier: the file is whole before any rank reads it
                all_reduce_sum(torch.zeros(1, device=device), group)
    return os.path.join(run_dir, CHECKPOINT)


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
