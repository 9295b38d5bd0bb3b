# The port's own copy of timetuning_tpu/data/loader.py (host code: numpy, no JAX), with its
# imports of the package renamed; tests/test_torch_host_copies.py pins it to the original.
# Its two device-facing helpers (device_prefetch, host_batch_to_device) are written for
# torch and CUDA streams: pinned host buffers, copies on a side stream.
"""Batched, prefetching clip loader + the ``make_loader`` factory.

Reference: ``make_loader`` (data_loader.py:1047-1110) — the central factory
dispatching davis / davis_val / ytvos / ytvos_val / visor / visor_val / mose
/ kinetics / epic-kitchen, adding a DistributedSampler when world_size > 1.

TPU-native differences:
  * decode threads fill a bounded queue of uint8 host batches; augmentation
    is NOT applied here — the training loop calls the fused on-device kernel
    (data/transforms.py) on the uint8 batch (host does IO only);
  * multi-host sharding is index-striding over the dataset
    (``rank::world_size``), the jax equivalent of DistributedSampler
    (reference data_loader.py:1105-1107) — each host feeds its own chips;
  * dataset locations come from an explicit ``roots`` mapping instead of the
    reference's hostname→path table (data_loader.py:78-94).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator

import numpy as np

from timetuning_tpu_torch.data.datasets import (
    KineticsDataset,
    SamplingMode,
    VideoDataset,
    YTVOSDataset,
)


class Batch(tuple):
    """(frames, annotations, labels) — unpacks like the historical 3-tuple —
    plus ``orig_sizes`` [B, 2] int32: each clip's native (H, W) before the
    square decode resize, feeding the aspect-preserving train-resize
    geometry (data/transforms.py ``src_sizes``), and ``gray_means`` [B, F]
    float32: per-frame PIL-exact native grayscale means, feeding the
    reference-exact contrast jitter. Either is None when the dataset does
    not report it."""

    orig_sizes: "np.ndarray | None"
    gray_means: "np.ndarray | None"

    def __new__(cls, frames, annotations, labels, orig_sizes=None,
                gray_means=None):
        b = super().__new__(cls, (frames, annotations, labels))
        b.orig_sizes = orig_sizes
        b.gray_means = gray_means
        return b


class ClipLoader:
    """Iterable over batched host clips with a PERSISTENT background decode
    pool.

    The worker threads outlive iterations and epochs (the round-3 loader
    spun a fresh pool per ``__iter__``, so every epoch paid thread start +
    a cold prefetch refill — at realistic B=128 epochs of a few steps that
    overhead dominated the measured pipeline). Batches are keyed
    ``(epoch, batch_index)``; after the current epoch's work is enqueued,
    the pool speculatively decodes the FIRST ``lookahead`` batches of the
    NEXT epoch (sampling is deterministic in ``(seed, epoch)``, and
    ``dataset.get_item(i, epoch)`` takes the epoch explicitly), so the
    epoch boundary costs nothing: batch (e+1, 0) is already decoded when
    ``set_epoch(e+1)`` arrives. Decoded-batch memory is bounded by
    consumer-side feeding to ``prefetch + num_workers`` in-flight batches
    (+1 transiently when recovering from an aborted pass)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        drop_last: bool = True,
        world_size: int = 1,
        rank: int = 0,
        seed: int = 1,
        prefetch: int = 4,
        lookahead: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.world_size = world_size
        self.rank = rank
        self.seed = seed
        self.prefetch = prefetch
        # next-epoch speculation depth; must stay below prefetch+workers so
        # speculated results can never starve the current epoch of permits
        self.lookahead = max(0, min(lookahead, prefetch + self.num_workers - 1))
        self._epoch = 0
        self._skip_next = 0
        # persistent pool state (created lazily on first iteration)
        self._pool: list[threading.Thread] = []
        self._tasks: queue.Queue = queue.Queue()
        self._cv = threading.Condition()
        self._results: dict = {}      # (epoch, bi) -> Batch | BaseException
        self._want: set = set()       # keys worth decoding / keeping
        self._enqueued: set = set()   # keys with a task in flight or queued
        self._iter_active = False     # a pooled __iter__ pass is live
        self._closed = False

    def skip_next_batches(self, n: int) -> None:
        """Drop the first ``n`` batches of the NEXT iteration (before any
        decode work) — mid-epoch checkpoint resume uses this to fast-forward
        to the first unconsumed batch. One-shot: consumed by one __iter__.
        Deterministic because the shuffle is keyed by (seed, epoch)."""
        self._skip_next = int(n)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _indices(self, epoch: int | None = None) -> list[int]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            if epoch is None:
                epoch = self._epoch
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(order)
        # Equal per-rank counts are load-bearing: when n % world_size != 0,
        # plain striding gives some ranks one extra index → one extra batch
        # → that rank enters a cross-host collective the others never join
        # (permanent hang). Pad with wrap-around to ceil(n/ws)·ws before
        # striding, exactly like the reference's DistributedSampler
        # (data_loader.py:1105-1107): full coverage, equal counts.
        if self.world_size > 1:
            per_rank = -(-n // self.world_size)
            total = per_rank * self.world_size
            if total > n:
                # cyclic repeat (a single slice can't cover n < world_size)
                reps = -(-total // n)
                order = np.tile(order, reps)[:total]
            order = order[self.rank :: self.world_size]
            assert len(order) == per_rank
        if self.drop_last:
            order = order[: len(order) - len(order) % self.batch_size]
        return order.tolist()

    def __len__(self) -> int:
        n = len(self.dataset)
        per_host = -(-n // self.world_size) if self.world_size > 1 else n
        if self.drop_last:
            return per_host // self.batch_size
        return (per_host + self.batch_size - 1) // self.batch_size

    # ---------------------------------------------------------------- #
    # persistent decode pool

    def _decode_batch(self, b: list[int], epoch: int) -> "Batch":
        get = getattr(self.dataset, "get_item", None)
        items = (
            [get(i, epoch) for i in b] if get is not None
            else [self.dataset[i] for i in b]
        )
        frames = np.stack([it["frames"] for it in items])
        annots = np.stack([it["annotations"] for it in items])
        labels = np.asarray([it["label"] for it in items])
        sizes = (
            np.stack([it["orig_size"] for it in items])
            if all("orig_size" in it for it in items)
            else None
        )
        gmeans = (
            np.stack([it["gray_means"] for it in items])
            if all("gray_means" in it for it in items)
            else None
        )  # [B, clips, F]
        # [B, clips, F, H, W, (3)] -> merge clips into batch
        # (the reference's squeeze for num_clips == 1; true batch-merge for
        # num_clips > 1, which downstream augment/step code consumes as a
        # [B*C] batch)
        if frames.shape[1] == 1:
            frames = frames[:, 0]
            annots = annots[:, 0]
            if gmeans is not None:
                gmeans = gmeans[:, 0]
        else:
            C = frames.shape[1]
            frames = frames.reshape((-1,) + frames.shape[2:])
            annots = annots.reshape((-1,) + annots.shape[2:])
            labels = np.repeat(labels, C)
            if sizes is not None:
                sizes = np.repeat(sizes, C, axis=0)
            if gmeans is not None:
                gmeans = gmeans.reshape((-1,) + gmeans.shape[2:])
        return Batch(frames, annots, labels, sizes, gmeans)

    def _worker(self) -> None:
        while True:
            task = self._tasks.get()
            if task is None:          # close() poison pill
                return
            key, b = task
            with self._cv:
                if key not in self._want:     # stale speculation: skip
                    self._enqueued.discard(key)
                    continue
            try:
                payload: object = self._decode_batch(b, key[0])
            except BaseException as e:  # noqa: BLE001
                # propagate instead of dying silently: a lost batch would
                # block the consumer forever on its index
                payload = e
            with self._cv:
                self._enqueued.discard(key)
                if key in self._want:
                    self._results[key] = payload
                    self._cv.notify_all()

    def _ensure_pool(self) -> None:
        if self._closed:
            raise RuntimeError("ClipLoader is closed")
        while len(self._pool) < self.num_workers:
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._pool.append(t)

    def _epoch_batches(self, epoch: int) -> list[list[int]]:
        order = self._indices(epoch)
        return [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]

    def _purge_except(self, keep: set) -> None:
        """Drop results/wants outside ``keep``."""
        with self._cv:
            self._want = set(keep)
            for key in [k for k in self._results if k not in keep]:
                del self._results[key]

    def close(self) -> None:
        """Stop the pool (optional: workers are daemon threads)."""
        self._purge_except(set())
        for _ in self._pool:
            self._tasks.put(None)
        self._closed = True
        self._pool = []

    def _inflight(self) -> int:
        """Queued + decoding + undelivered results among wanted keys.
        Callers must hold ``self._cv``."""
        return sum(
            1 for k in self._want
            if k in self._enqueued or k in self._results
        )

    def _speculation_safe(self) -> bool:
        # Next-epoch speculation decodes (epoch+1)-keyed batches while the
        # dataset's shared epoch is still e. That is only sound when decode
        # is epoch-explicit (``get_item(i, epoch)``) or epoch-independent
        # (no ``set_epoch`` at all) — a duck-typed dataset with
        # set_epoch-dependent ``__getitem__`` would silently serve epoch-e
        # content as epoch e+1.
        return (
            getattr(self.dataset, "get_item", None) is not None
            or not hasattr(self.dataset, "set_epoch")
        )

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        epoch = self._epoch
        batches = self._epoch_batches(epoch)
        skip, self._skip_next = self._skip_next, 0
        expected = [((epoch, bi), b) for bi, b in enumerate(batches)][skip:]
        if not expected:
            return
        if self._iter_active:
            # a second live iterator over the same loader (zip(loader,
            # loader), a diagnostics thread, ...): decode synchronously
            # rather than fight the first pass over the shared pool state
            for _, b in expected:
                yield self._decode_batch(b, epoch)
            return
        self._ensure_pool()
        self._iter_active = True

        # speculation for the NEXT epoch: sampling is (seed, epoch)-keyed,
        # so (epoch+1, bi) batches are known now; decode the first few so
        # the next epoch's pipeline starts warm instead of refilling cold
        spec = []
        if self._speculation_safe():
            spec = [
                ((epoch + 1, bi), b)
                for bi, b in enumerate(self._epoch_batches(epoch + 1))
            ][: self.lookahead]

        keep = {k for k, _ in expected} | {k for k, _ in spec}
        self._purge_except(keep)

        # consumer-side feeding bounds decoded-batch memory WITHOUT a
        # blocking acquire in the workers (a semaphore there can deadlock:
        # later-key results can hold every permit while the head key's
        # worker waits). In-flight (queued + decoding + undelivered results)
        # never exceeds prefetch + num_workers; capacity is re-measured on
        # every wakeup (a one-shot budget deadlocks when an aborted earlier
        # pass left later-key tasks enqueued), and the head key is enqueued
        # unconditionally if feeding in order never reached it — bounded
        # overshoot of one batch, in exchange for guaranteed progress.
        cap = self.prefetch + self.num_workers
        feed = expected + spec
        fed = 0

        def _pump() -> None:
            nonlocal fed
            while True:
                with self._cv:
                    if fed >= len(feed) or self._inflight() >= cap:
                        return
                    k, b = feed[fed]
                    fed += 1
                    if k in self._enqueued or k in self._results:
                        continue
                    self._enqueued.add(k)
                self._tasks.put((k, b))

        def _force_feed(key, b) -> None:
            with self._cv:
                if key in self._enqueued or key in self._results:
                    return
                self._enqueued.add(key)
            self._tasks.put((key, b))

        try:
            for key, b in expected:
                _pump()
                _force_feed(key, b)
                with self._cv:
                    while key not in self._results:
                        self._cv.wait()
                    payload = self._results.pop(key)
                    self._want.discard(key)
                if isinstance(payload, BaseException):
                    raise payload
                yield payload
        finally:
            self._iter_active = False
            # early break / exception / completion: keep only next-epoch
            # speculation alive, and feed it best-effort within capacity
            # (anything unfed here is fed by the next __iter__)
            self._purge_except({k for k, _ in spec})
            with self._cv:
                room = max(0, cap - self._inflight())
                spec_todo = [
                    (k, b) for k, b in spec
                    if k not in self._enqueued and k not in self._results
                ][:room]
                for k, _ in spec_todo:
                    self._enqueued.add(k)
            for task in spec_todo:
                self._tasks.put(task)


def device_prefetch(iterable, transform, depth: int = 2, stream=None):
    """Overlap the host-to-device copy with the device's work: keep
    ``depth`` transformed items in flight ahead of the consumer.

    ``transform(item)`` puts an item on the device (``host_batch_to_device``
    and ``non_blocking`` copies from pinned memory return at once). With a
    CUDA ``stream`` the transform runs on that side stream; before an item
    is handed out, the consumer's current stream waits on an event recorded
    after its copies, and each of its tensors is marked as used by the
    consumer's stream, so the caching allocator does not hand its memory to
    another copy while the consumer still reads it."""
    import torch

    it = iter(iterable)
    from collections import deque

    buf = deque()

    def enqueue(k: int) -> None:
        for _ in range(k):
            try:
                item = next(it)
            except StopIteration:
                return
            if stream is None:
                buf.append((transform(item), None))
                continue
            with torch.cuda.stream(stream):
                out = transform(item)
                done = torch.cuda.Event()
                done.record(stream)
            buf.append((out, done))

    enqueue(depth)
    while buf:
        out, done = buf.popleft()
        if done is not None:
            consumer = torch.cuda.current_stream(stream.device)
            consumer.wait_event(done)
            for t in _tensors(out):
                if t.is_cuda:
                    t.record_stream(consumer)
        enqueue(1)
        yield out


def _tensors(x):
    import torch

    if torch.is_tensor(x):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def host_batch_to_device(local_np, device):
    """Put one host array on ``device``: pinned host memory, then an
    asynchronous copy (``non_blocking``) that rides the copy engine while the
    device computes. Single process: a run over several processes shards the
    batch across them, which the port does not do yet (ROADMAP.md queue 1
    item 11, 'Parallel axes')."""
    import torch

    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "host_batch_to_device: a batch sharded over processes is not ported "
            "yet (ROADMAP.md queue 1 item 11, 'Parallel axes')")
    t = torch.from_numpy(np.ascontiguousarray(local_np))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


_DATASET_FACTORIES = {}


def register_dataset(name: str):
    def deco(fn):
        _DATASET_FACTORIES[name] = fn
        return fn
    return deco


def _davis_layout(root):
    frames = os.path.join(root, "JPEGImages", "480p")
    annots = os.path.join(root, "Annotations", "480p")
    if not os.path.isdir(frames):
        frames = os.path.join(root, "JPEGImages")
        annots = os.path.join(root, "Annotations")
    return frames, annots


def _split_filter(root, split: str) -> frozenset | None:
    """Video names from a DAVIS-style ImageSets split list, when present.

    The reference has no split filtering — its davis_val points at a
    pre-split val-only tree (data_loader.py:1061-1063). On a STANDARD
    DAVIS root (train+val together under JPEGImages), evaluating without
    this filter would silently mix train videos into the val metric."""
    for cand in (f"ImageSets/2017/{split}.txt", f"ImageSets/480p/{split}.txt"):
        path = os.path.join(root, cand)
        if os.path.exists(path):
            with open(path) as f:
                names = frozenset(x.strip() for x in f if x.strip())
            if names:
                return names
    return None


@register_dataset("davis")
@register_dataset("davis_val")
@register_dataset("mose")
@register_dataset("visor")
@register_dataset("visor_val")
@register_dataset("epic-kitchen")
def _build_davis_like(name, root, pack_path=None, **kw):
    frames, annots = _davis_layout(root)
    if name.endswith("_val") and kw.get("video_filter") is None:
        kw["video_filter"] = _split_filter(root, "val")
    if pack_path:
        from timetuning_tpu_torch.data.datasets import PackedVideoDataset

        return PackedVideoDataset(
            frames_root=frames, annotations_root=annots, pack_path=pack_path, **kw
        )
    return VideoDataset(frames_root=frames, annotations_root=annots, **kw)


@register_dataset("ytvos")
@register_dataset("ytvos_val")
def _build_ytvos(name, root, pack_path=None, **kw):
    split = "valid" if name.endswith("_val") else "train"
    base = os.path.join(root, split)
    if not os.path.isdir(base):
        base = root
    meta = os.path.join(base, "meta.json")
    common = dict(
        frames_root=os.path.join(base, "JPEGImages"),
        annotations_root=os.path.join(base, "Annotations"),
        meta_file=meta if os.path.exists(meta) else None,
        **kw,
    )
    if pack_path:
        from timetuning_tpu_torch.data.datasets import PackedYTVOSDataset

        return PackedYTVOSDataset(pack_path=pack_path, **common)
    return YTVOSDataset(**common)


@register_dataset("kinetics")
def _build_kinetics(name, root, pack_path=None, **kw):
    kw.pop("annotations_root", None)
    if pack_path:
        from timetuning_tpu_torch.data.datasets import PackedVideoDataset

        # annotation-free: PackedVideoDataset with an empty annotation tree
        # returns zero masks, exactly like KineticsDataset
        return PackedVideoDataset(
            frames_root=root, annotations_root="", pack_path=pack_path, **kw
        )
    return KineticsDataset(frames_root=root, **kw)


def make_loader(
    dataset_name: str,
    num_clip_frames: int,
    batch_size: int,
    regular_step: int = 1,
    sampling_mode: SamplingMode = SamplingMode.UNIFORM,
    shuffle: bool = True,
    num_workers: int = 4,
    world_size: int = 1,
    rank: int = 0,
    root: str | None = None,
    decode_size: int = 256,
    num_clips: int = 1,
    drop_last: bool = True,
    pack_path: str | None = None,
    seed: int = 1,
    **kw,
) -> ClipLoader:
    """Reference-compatible factory (data_loader.py:1047-1110 flag surface,
    minus the host→device transform arguments, which became the fused
    on-device augmentation)."""
    if root is None:
        root = os.environ.get("TIMETUNING_DATA_ROOT", "")
        root = os.path.join(root, dataset_name.replace("_val", ""))
    factory = _DATASET_FACTORIES.get(dataset_name)
    if factory is None:
        raise ValueError(
            f"unknown dataset {dataset_name!r}; known: {sorted(_DATASET_FACTORIES)}"
        )
    if pack_path is not None:
        kw["pack_path"] = pack_path
    ds = factory(
        dataset_name,
        root,
        sampling_mode=sampling_mode,
        num_clips=num_clips,
        num_frames=num_clip_frames,
        decode_size=decode_size,
        regular_step=regular_step,
        seed=seed,
        **kw,
    )
    if len(ds) == 0:
        raise ValueError(
            f"dataset {dataset_name!r} at {root!r} contains no videos — "
            "check --data_root (or TIMETUNING_DATA_ROOT); training on an "
            "empty loader would silently run zero steps per epoch"
        )
    return ClipLoader(
        ds,
        batch_size=batch_size,
        shuffle=shuffle,
        num_workers=num_workers,
        world_size=world_size,
        rank=rank,
        drop_last=drop_last,
        seed=seed,
    )


def sampling_mode(name: str) -> SamplingMode:
    """``SamplingMode[name]``, for callers that take the mode as a string."""
    return SamplingMode[name]
