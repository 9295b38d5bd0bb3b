# The port's own copy of timetuning_tpu/data/datasets.py (host code: numpy, no JAX), with its
# imports of the package renamed; tests/test_torch_host_copies.py pins it to the original.
"""Host-side dataset layer: directory trees, clip samplers, frame decode.

Reference: data_loader.py — ``build_dataset_tree`` (:509-540, incl. automatic
video→frame-dir conversion), ``SamplingMode`` (:432-437), ``VideoDataset``
(:543-767) with per-video frame dirs and aligned annotation dirs,
``YVOSDataset`` meta.json category mapping (:453-506, 774-796), ``Kinetics``
(:800-817), split/renaming utilities (:1132-1170).

TPU-first split of responsibilities: this module only *decodes* — every clip
is returned as fixed-size uint8 numpy (frames square-resized to
``decode_size``), and all augmentation happens in the fused on-device kernel
(data/transforms.py). Decode uses OpenCV (vendored C++ JPEG/PNG codecs),
which is also what the reference used underneath PIL/cv2.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import random
import re
import shutil
from typing import Callable

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

VIDEO_EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv", ".webm")
FRAME_EXTENSIONS = (".jpg", ".jpeg", ".png")


class SamplingMode(enum.Enum):
    """Clip sampling modes (reference data_loader.py:432-437)."""

    UNIFORM = 0   # sorted sample without replacement (with, if too short)
    DENSE = 1     # random contiguous window
    FULL = 2      # all frames
    REGULAR = 3   # strided window with random base (stride = regular_step)


def convert_video_to_frames(video_path: str, out_dir: str) -> int:
    """Decode a video file into a directory of numbered jpgs
    (reference data_loader.py:523-532)."""
    assert cv2 is not None, "OpenCV required for video decode"
    # decode into a temp dir and rename on success: a killed/failed
    # conversion must not leave a partial dir that later runs trust as
    # complete (the existence check in build_dataset_tree)
    tmp = out_dir + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    cap = cv2.VideoCapture(video_path)
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        cv2.imwrite(os.path.join(tmp, f"{n:05d}.jpg"), frame)
        n += 1
    cap.release()
    if n == 0:
        raise ValueError(f"no frames decoded from {video_path}")
    os.rename(tmp, out_dir)
    return n


def build_dataset_tree(root: str, convert_videos: bool = True) -> dict[str, list[str]]:
    """Walk ``root``; return {leaf frame-dir: sorted frame paths}.

    Video files encountered are converted to per-video frame dirs first
    (reference data_loader.py:509-540).
    """
    tree: dict[str, list[str]] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        # numeric frame order: identical to lexicographic for zero-padded
        # names (DAVIS/YTVOS/frame dumps, and the reference's plain sorted(),
        # data_loader.py:597-599) but robust to unpadded "1.jpg ... 120.jpg"
        # trees, which lexicographic order would temporally scramble
        frames = sorted(
            (f for f in filenames if f.lower().endswith(FRAME_EXTENSIONS)),
            key=_numeric_key,
        )
        videos = [f for f in filenames if f.lower().endswith(VIDEO_EXTENSIONS)]
        if videos and convert_videos:
            for v in videos:
                stem = os.path.splitext(v)[0]
                vdir = os.path.join(dirpath, stem)
                if not os.path.isdir(vdir):
                    convert_video_to_frames(os.path.join(dirpath, v), vdir)
                if stem not in dirnames:
                    dirnames.append(stem)  # let os.walk descend into it
        if frames:
            tree[dirpath] = [os.path.join(dirpath, f) for f in frames]
    return tree


def _numeric_key(path: str):
    m = re.findall(r"\d+", os.path.basename(path))
    return (int(m[-1]) if m else 0, path)


def generate_clip_indices(
    rng: random.Random,
    size: int,
    num_frames: int,
    num_clips: int,
    mode: SamplingMode,
    regular_step: int = 1,
) -> list[list[int]]:
    """The four sampling modes (semantics of reference
    data_loader.py:617-642)."""
    out = []
    for _ in range(num_clips):
        if mode == SamplingMode.UNIFORM:
            if size < num_frames:
                idx = rng.choices(range(size), k=num_frames)
            else:
                idx = rng.sample(range(size), num_frames)
            idx.sort()
        elif mode == SamplingMode.DENSE:
            base = rng.randint(0, max(size - num_frames, 0))
            idx = list(range(base, base + num_frames))
            idx = [min(i, size - 1) for i in idx]
        elif mode == SamplingMode.FULL:
            idx = list(range(size))
        elif mode == SamplingMode.REGULAR:
            step = size // num_frames if size < num_frames * regular_step else regular_step
            step = max(step, 1)
            hi = max(size - num_frames * step, 0)
            base = rng.randint(0, hi)
            idx = [min(base + i * step, size - 1) for i in range(num_frames)]
        else:
            raise ValueError(mode)
        out.append(idx)
    return out


def _frame_size(path: str) -> tuple[int, int]:
    """Native (H, W) of an image file — header-only read (no full decode)."""
    from PIL import Image

    with Image.open(path) as im:
        w, h = im.size
    return h, w


_REDUCED_FLAGS = (
    (8, cv2.IMREAD_REDUCED_COLOR_8),
    (4, cv2.IMREAD_REDUCED_COLOR_4),
    (2, cv2.IMREAD_REDUCED_COLOR_2),
) if cv2 is not None else ()


def _native_gray_mean(rgb: np.ndarray) -> float:
    """PIL-exact grayscale mean of an RGB uint8 frame, in [0, 255].

    Reproduces ``ImageStat.Stat(img.convert("L")).mean[0]`` — the quantity
    PIL's ImageEnhance.Contrast (the backend of torchvision
    ``adjust_contrast``, which the reference's ColorJitter applies to the
    NATIVE frame, video_transformations.py:745) blends toward. Computed at
    decode time because the native aspect-correct frame exists only here;
    threaded to the fused augmentation kernel as ``gray_means``."""
    v = (19595 * rgb[..., 0].astype(np.int32)
         + 38470 * rgb[..., 1].astype(np.int32)
         + 7471 * rgb[..., 2].astype(np.int32) + 32768) >> 16
    return float(v.mean())


def _decode_frame(path: str, size: int, nearest: bool,
                  reduce_for: tuple[int, int] | None = None,
                  ) -> tuple[np.ndarray, float]:
    """Decode one frame and resize to the square decode buffer. Returns
    ``(buffer, native_gray_mean)`` — the PIL-exact grayscale mean of the
    pre-resize frame (see :func:`_native_gray_mean`).

    ``reduce_for``: the frame's native (H, W) — when given and the file is
    a JPEG whose short side is ≥ 2× the buffer, ask libjpeg for the
    largest DCT-domain 1/k scale that still covers the buffer
    (IMREAD_REDUCED_COLOR_k skips the full-resolution IDCT; measures
    ~1.7× faster on realistic 720p content). Opt-in (``fast_decode``):
    the scaled IDCT is a different — better-antialiased — downsampling
    than the reference's full decode + bilinear, so pixels differ
    slightly from the faithful path — and the gray mean is then computed
    on the reduced decode rather than the native frame (the 1/k scale is
    a block average, so the mean deviates only by block-rounding, but it
    is not bit-PIL-exact; part of the same documented opt-in divergence).
    The faithful default path computes it on the full native decode."""
    flags = cv2.IMREAD_UNCHANGED
    if reduce_for is not None and path.lower().endswith((".jpg", ".jpeg")):
        short = min(reduce_for)
        for k, f in _REDUCED_FLAGS:
            if short >= k * size:
                flags = f
                break
    img = cv2.imread(path, flags)
    if img is None:
        # truncated/corrupt/zero-byte file: fail loudly with the path —
        # a silent zero frame would poison the SSL batch undetectably
        raise ValueError(f"failed to decode image file {path}")
    if flags != cv2.IMREAD_UNCHANGED and min(img.shape[:2]) < size:
        # Mixed-resolution video: ``reduce_for`` is the first frame's size,
        # and the 1/k factor picked from it overshot this smaller frame —
        # a reduced decode below the buffer would silently upscale (softer
        # than the faithful path). Re-decode at full resolution.
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    if img.dtype == np.uint16:   # 16-bit sources: take the high byte, do
        img = (img >> 8).astype(np.uint8)   # not modulo-wrap into uint8
    if img.ndim == 2:            # grayscale → replicated RGB
        img = np.repeat(img[..., None], 3, axis=-1)
    elif img.shape[2] >= 3:
        img = cv2.cvtColor(img[..., :3], cv2.COLOR_BGR2RGB)
    gray_mean = _native_gray_mean(img)
    img = cv2.resize(img, (size, size), interpolation=interp)
    return img, gray_mean


def _decode_annotation(path: str, size: int) -> np.ndarray:
    """Decode a segmentation annotation preserving OBJECT IDS.

    DAVIS/YTVOS annotations are palette-indexed PNGs whose pixel values are
    object indices; OpenCV cannot return raw palette indices (it expands to
    BGR, turning object 1 into color (128, 0, 0) — ids corrupted). PIL's
    'P' mode yields the indices directly, matching the reference's
    ``Image.open`` reads (data_loader.py:664-666)."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode in ("P", "L", "I", "I;16"):
            a = np.asarray(im)
        else:
            a = np.asarray(im.convert("L"))
    if a.dtype != np.uint8:
        # wide-dtype annotations (16/32-bit instance exports): ids beyond
        # 255 cannot fit the uint8 annotation buffers — fail loudly rather
        # than wrap id 256 to background
        if a.max(initial=0) > 255:
            raise ValueError(
                f"annotation {path} holds ids > 255 (max {int(a.max())}); "
                "uint8 annotation buffers cannot represent them"
            )
        a = a.astype(np.uint8)
    return cv2.resize(a, (size, size), interpolation=cv2.INTER_NEAREST)


@dataclasses.dataclass
class VideoDataset:
    """Per-video frame dirs (+ aligned annotation dirs).

    ``__getitem__`` → dict with
      ``frames``      [num_clips, F, decode, decode, 3] uint8
      ``annotations`` [num_clips, F, decode, decode] uint8 (zeros if absent)
      ``label``       video index
    """

    frames_root: str
    annotations_root: str = ""
    sampling_mode: SamplingMode = SamplingMode.UNIFORM
    num_clips: int = 1
    num_frames: int = 4
    decode_size: int = 256
    regular_step: int = 1
    seed: int = 1
    map_annotations: Callable[[np.ndarray, str], np.ndarray] | None = None
    # JPEG DCT-domain reduced decode when the source is ≥2× the decode
    # buffer (see _decode_frame) — opt-in; annotations are never reduced
    fast_decode: bool = False
    # restrict to these video basenames (e.g. an ImageSets split list)
    video_filter: frozenset | None = None
    # False: skip annotation decode entirely (items carry a [C, F, 1, 1]
    # zero placeholder). The TRAINING loader sets this: the SSL loss never
    # reads annotations, yet decoding their palette PNGs costs ~25× the
    # packed frame gather (measured 7.6 vs 0.3 ms/item on a 480p tree) —
    # the dominant host cost of the real-data train pipeline.
    load_annotations: bool = True

    def __post_init__(self):
        self.tree = build_dataset_tree(self.frames_root)
        self.keys = sorted(self.tree.keys())
        if self.video_filter is not None:
            self.keys = [
                k for k in self.keys
                if os.path.basename(k) in self.video_filter
            ]
        self.use_annotations = bool(self.annotations_root) and os.path.exists(
            self.annotations_root
        )
        if self.use_annotations:
            ann_tree = build_dataset_tree(self.annotations_root, convert_videos=False)
            ann_keys = sorted(ann_tree.keys())
            if self.video_filter is not None:
                ann_keys = [
                    k for k in ann_keys
                    if os.path.basename(k) in self.video_filter
                ]
            self.ann_keys = ann_keys
            self.ann_tree = ann_tree
            # pairing is positional over two independently sorted walks — a
            # count check alone would let a stray frame-bearing dir silently
            # shift every video onto ANOTHER video's annotations
            names = [os.path.basename(k) for k in self.keys]
            ann_names = [os.path.basename(k) for k in self.ann_keys]
            if names != ann_names:
                diff = sorted(set(names) ^ set(ann_names))[:5]
                raise ValueError(
                    f"frame/annotation video names do not align "
                    f"({len(names)} vs {len(ann_names)}; first diffs "
                    f"{diff}) — frames_root and annotations_root must hold "
                    "the same per-video directory names"
                )
        self._epoch = 0

    def __len__(self):
        return len(self.keys)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _rng(self, index: int, epoch: int | None = None) -> random.Random:
        if epoch is None:
            epoch = self._epoch
        return random.Random((self.seed * 1_000_003 + epoch) * 97 + index)

    def video_name(self, index: int) -> str:
        return os.path.basename(self.keys[index])

    def orig_size(self, index: int) -> tuple[int, int]:
        """Native (H, W) of the video's frames before the square decode
        resize — the geometry the reference's short-side train Resize sees
        (video_transformations.py:96-103). Cached per video (header read)."""
        cache = getattr(self, "_orig_size_cache", None)
        if cache is None:
            cache = self._orig_size_cache = {}
        if index not in cache:
            cache[index] = _frame_size(self.tree[self.keys[index]][0])
        return cache[index]

    def __getitem__(self, index: int) -> dict:
        return self.get_item(index)

    def get_item(self, index: int, epoch: int | None = None) -> dict:
        """Like ``__getitem__`` but with the sampling epoch passed
        explicitly — the persistent loader pool decodes the NEXT epoch's
        batches ahead of ``set_epoch``, so it cannot rely on the shared
        ``_epoch`` attribute (thread-safety)."""
        key = self.keys[index]
        files = self.tree[key]
        rng = self._rng(index, epoch)
        clip_idx = generate_clip_indices(
            rng, len(files), self.num_frames, self.num_clips,
            self.sampling_mode, self.regular_step,
        )
        F = len(clip_idx[0])
        frames = np.zeros(
            (self.num_clips, F, self.decode_size, self.decode_size, 3), np.uint8
        )
        annots = self._annotation_buffer(F)
        gray_means = np.zeros((self.num_clips, F), np.float32)
        reduce_for = self.orig_size(index) if self.fast_decode else None
        for c, idx in enumerate(clip_idx):
            for f, i in enumerate(idx):
                frames[c, f], gray_means[c, f] = _decode_frame(
                    files[i], self.decode_size, nearest=False,
                    reduce_for=reduce_for,
                )
        if self.load_annotations:
            self._fill_annotations(annots, clip_idx, index)
        return {
            "frames": frames, "annotations": annots, "label": index,
            "orig_size": np.asarray(self.orig_size(index), np.int32),
            "gray_means": gray_means,
        }

    def _annotation_buffer(self, F: int) -> np.ndarray:
        if not self.load_annotations:
            return np.zeros((self.num_clips, F, 1, 1), np.uint8)
        return np.zeros(
            (self.num_clips, F, self.decode_size, self.decode_size), np.uint8
        )

    def _fill_annotations(self, annots, clip_idx, index: int) -> None:
        """Decode + remap the clip's annotation frames into ``annots``
        in place (shared by the JPEG and packed datasets)."""
        if not self.use_annotations:
            return
        ann_files = self.ann_tree[self.ann_keys[index]]
        for c, idx in enumerate(clip_idx):
            for f, i in enumerate(idx):
                if i < len(ann_files):
                    a = _decode_annotation(ann_files[i], self.decode_size)
                    if self.map_annotations is not None:
                        a = self.map_annotations(a, self.ann_keys[index])
                    annots[c, f] = a


def make_categories_dict(meta_path: str) -> dict[str, dict[str, int]]:
    """YouTube-VOS meta.json: per-video {object id → category id}
    (reference ``make_categories_dict``, data_loader.py:453-480)."""
    with open(meta_path) as f:
        meta = json.load(f)
    categories: dict[str, int] = {}
    mapping: dict[str, dict[str, int]] = {}
    for vid, info in meta["videos"].items():
        objs = {}
        for oid, obj in info["objects"].items():
            cat = obj["category"]
            if cat not in categories:
                categories[cat] = len(categories) + 1
            objs[oid] = categories[cat]
        mapping[vid] = objs
    return mapping


class _InstanceRemapMixin:
    """meta.json instance→category remap shared by the decoded and packed
    YTVOS datasets (reference ``YVOSDataset.map_instances``,
    data_loader.py:482-506, 774-796)."""

    instance_map: dict | None

    def __init__(self, *args, meta_file: str | None = None, **kw):
        super().__init__(*args, **kw)
        self._init_instance_map(meta_file)

    def get_item(self, index: int, epoch: int | None = None) -> dict:
        return self._remap_instances(super().get_item(index, epoch), index)

    def _init_instance_map(self, meta_file: str | None) -> None:
        self.instance_map = make_categories_dict(meta_file) if meta_file else None

    def _remap_instances(self, item: dict, index: int) -> dict:
        if self.instance_map is not None and self.use_annotations:
            vid = os.path.basename(self.ann_keys[index])
            objs = self.instance_map.get(vid, {})
            ann = item["annotations"]
            out = np.zeros_like(ann)
            for oid, cat in objs.items():
                out[ann == int(oid)] = cat
            item["annotations"] = out
        return item


class YTVOSDataset(_InstanceRemapMixin, VideoDataset):
    """VideoDataset + meta.json instance→category remapping (the mixin owns
    the ``meta_file`` kwarg and the __getitem__ remap)."""


class KineticsDataset(VideoDataset):
    """Frame-dir video dataset without annotations
    (reference data_loader.py:800-817)."""

    def __init__(self, frames_root: str, **kw):
        kw.pop("annotations_root", None)
        super().__init__(frames_root, annotations_root="", **kw)


class PackedVideoDataset(VideoDataset):
    """VideoDataset reading from a decode-once packed frame cache.

    Build the pack with ``timetuning_tpu_torch.native.build_clip_pack``; training
    epochs then assemble batches by native threaded memcpy gathers out of
    the mmap'd pack instead of re-decoding JPEGs (the reference re-decoded
    every frame every epoch in Python workers, data_loader.py:595-614).
    Annotations (eval-only, small) still come from the annotation tree.
    """

    def __init__(self, *args, pack_path: str, **kw):
        super().__init__(*args, **kw)
        from timetuning_tpu_torch.native import ClipPack

        self.pack = ClipPack(pack_path)
        with open(pack_path + ".index.json") as f:
            self.pack_index = json.load(f)
        assert self.pack.h == self.decode_size == self.pack.w, (
            f"pack built at {self.pack.h}x{self.pack.w}, dataset expects "
            f"{self.decode_size}"
        )

    def orig_size(self, index: int) -> tuple[int, int]:
        entry = self.pack_index[os.path.basename(self.keys[index])]
        if len(entry) >= 4:  # (start, n, h0, w0) — recorded at pack build
            return int(entry[2]), int(entry[3])
        return super().orig_size(index)  # legacy (start, n) index

    def get_item(self, index: int, epoch: int | None = None) -> dict:
        key = self.keys[index]
        name = os.path.basename(key)
        start, n = self.pack_index[name][:2]
        rng = self._rng(index, epoch)
        clip_idx = generate_clip_indices(
            rng, n, self.num_frames, self.num_clips,
            self.sampling_mode, self.regular_step,
        )
        F = len(clip_idx[0])
        flat = np.asarray([start + i for c in clip_idx for i in c], np.int64)
        frames = self.pack.gather(flat).reshape(
            self.num_clips, F, self.decode_size, self.decode_size, 3
        )
        annots = self._annotation_buffer(F)
        if self.load_annotations:
            self._fill_annotations(annots, clip_idx, index)
        item = {
            "frames": frames, "annotations": annots, "label": index,
            "orig_size": np.asarray(self.orig_size(index), np.int32),
        }
        entry = self.pack_index[name]
        if len(entry) >= 5:  # native per-frame grayscale means (pack build)
            all_means = np.asarray(entry[4], np.float32)
            item["gray_means"] = np.stack(
                [all_means[np.asarray(c)] for c in clip_idx]
            )
        return item


class PackedYTVOSDataset(_InstanceRemapMixin, PackedVideoDataset):
    """Decode-once packed cache for the flagship YTVOS training set: packed
    frame gathers + meta.json instance→category annotation remap (the
    reference's default training dataset, time_tuning.py:686). Annotations
    are eval-only and stay in the annotation tree; only the mapping table is
    needed, so the pack format itself is unchanged. The mixin owns the
    ``meta_file`` kwarg and the __getitem__ remap."""


# ------------------------------------------------------------------ #
# dataset-management utilities

def train_val_split(root: str, val_fraction: float, seed: int = 1):
    """Partition video dirs into train/val name lists
    (reference data_loader.py:1132-1150)."""
    names = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    rng = random.Random(seed)
    rng.shuffle(names)
    n_val = int(len(names) * val_fraction)
    return names[n_val:], names[:n_val]


def zero_index_directory(path: str) -> None:
    """Rename frames to a dense zero-based %05d numbering
    (reference data_loader.py:1152-1170)."""
    files = sorted(
        (f for f in os.listdir(path) if f.lower().endswith(FRAME_EXTENSIONS)),
        key=_numeric_key,
    )
    for i, f in enumerate(files):
        ext = os.path.splitext(f)[1]
        src = os.path.join(path, f)
        dst = os.path.join(path, f"{i:05d}{ext}")
        if src != dst:
            shutil.move(src, dst)


def diff_annotation_data_directories(frames_root: str, annotations_root: str):
    """Report videos whose frame/annotation counts disagree
    (reference data_loader.py:440-450)."""
    ftree = build_dataset_tree(frames_root, convert_videos=False)
    atree = build_dataset_tree(annotations_root, convert_videos=False)
    fkeys = {os.path.basename(k): len(v) for k, v in ftree.items()}
    akeys = {os.path.basename(k): len(v) for k, v in atree.items()}
    return {
        name: (fkeys.get(name, 0), akeys.get(name, 0))
        for name in set(fkeys) | set(akeys)
        if fkeys.get(name, 0) != akeys.get(name, 0)
    }
