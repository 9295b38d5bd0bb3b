# The port's own copy of timetuning_tpu/native.py (host code: numpy, no JAX), with its
# imports of the package renamed; tests/test_torch_host_copies.py pins it to the original.
"""ctypes bindings for the native runtime (native/*.cpp).

Two components, both with pure-Python fallbacks so the framework works
without a compiler:

  * ``hungarian``  — C++ shortest-augmenting-path assignment solver used by
    the evaluation matching (falls back to scipy);
  * ``ClipPack``   — mmap'd packed-frame store with threaded C++ batch
    gather, the decode-once data runtime for training (falls back to a
    numpy memmap gather).

The shared library is built lazily with ``make -C native`` (g++) on first
use and cached under ``native/build/``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libtimetuning_native.so")

_lib = None
_lib_failed = False  # failed build/load: cache it — never retry per call
_lib_lock = threading.Lock()

_HEADER_BYTES = 5 * 8
_MAGIC = 0x54504C43


def _load_library():
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _lib_failed:
            # a host without g++ must not re-spawn a failing `make` on
            # every hungarian() call (it sits on the per-frame eval path)
            return None
        if not os.path.exists(_LIB_PATH):
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR],
                    check=True, capture_output=True, timeout=120,
                )
            except Exception:
                _lib_failed = True
                return None
        try:
            # symbol binding inside the guard: a stale prebuilt .so from an
            # older source tree missing newer symbols degrades to the
            # Python fallbacks instead of raising AttributeError mid-eval
            lib = ctypes.CDLL(_LIB_PATH)
            lib.hungarian_solve.restype = ctypes.c_int
            lib.hungarian_solve.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.clippack_open.restype = ctypes.c_int64
            lib.clippack_open.argtypes = [ctypes.c_char_p]
            lib.clippack_info.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
            lib.clippack_gather.restype = ctypes.c_int
            lib.clippack_gather.argtypes = [
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ]
            lib.clippack_close.argtypes = [ctypes.c_int64]
        except (OSError, AttributeError):
            _lib_failed = True
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_library() is not None


def hungarian(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Min-cost assignment; returns (row_indices, col_indices) like scipy's
    ``linear_sum_assignment``. Uses the C++ solver when built."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    n_rows, n_cols = cost.shape
    lib = _load_library()
    if lib is None:
        from scipy.optimize import linear_sum_assignment

        return linear_sum_assignment(cost)
    transposed = n_rows > n_cols
    if transposed:
        cost = np.ascontiguousarray(cost.T)
        n_rows, n_cols = n_cols, n_rows
    out = np.full(n_rows, -1, dtype=np.int32)
    rc = lib.hungarian_solve(
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_rows, n_cols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        from scipy.optimize import linear_sum_assignment

        return linear_sum_assignment(cost.T if transposed else cost)
    rows = np.arange(n_rows)
    if transposed:
        # scipy contract: row_ind ascending. `out` here is the matched
        # ORIGINAL-row per original-column, i.e. unsorted rows.
        order = np.argsort(out, kind="stable")
        return out[order].astype(np.int64), rows[order]
    return rows, out.astype(np.int64)


# ------------------------------------------------------------------ #
# packed clip cache


def write_clip_pack(path: str, frames: np.ndarray) -> None:
    """Write frames [N, H, W, C] uint8 into a pack file."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    n, h, w, c = frames.shape
    header = np.asarray([_MAGIC, n, h, w, c], dtype=np.int64)
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(frames.tobytes())


def build_clip_pack(
    dataset, path: str, index_path: str | None = None
) -> dict:
    """Decode every frame of a VideoDataset tree once into a pack.

    Returns the index: {video name: (start_frame, n_frames, native_h,
    native_w, [per-frame native grayscale means])} and writes it as JSON
    next to the pack. The native dims feed the aspect-preserving
    train-resize geometry and the means feed the reference-exact contrast
    jitter (data/transforms.py); legacy (start, n) and (start, n, h, w)
    indices are still readable (square / buffer-mean fallbacks).
    """
    import json

    from timetuning_tpu_torch.data.datasets import _decode_frame, _frame_size

    fast = bool(getattr(dataset, "fast_decode", False))
    index: dict[str, tuple[int, int]] = {}
    s = dataset.decode_size
    n_total = sum(len(dataset.tree[key]) for key in dataset.keys)
    start = 0
    # stream frame-by-frame: the fixed-record layout needs no buffering, and
    # materializing a YTVOS-scale pack (~20 GB) plus an np.stack copy would
    # OOM exactly the datasets the pack exists for. Write to a temp path and
    # os.replace on success — a mid-build failure (corrupt JPEG, Ctrl-C)
    # must not leave a truncated pack that later exists-checks trust.
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(np.asarray([_MAGIC, n_total, s, s, 3], np.int64).tobytes())
            for key in dataset.keys:
                name = os.path.basename(key)
                if name in index:
                    raise ValueError(
                        f"duplicate video basename {name!r} (under different "
                        "parents) — the pack index is keyed by basename; "
                        "rename or split the tree into separate packs"
                    )
                files = dataset.tree[key]
                native_h, native_w = _frame_size(files[0])
                # same decode path as the live loader — dataset.fast_decode
                # (reduced DCT-domain JPEG decode) applies to the one-time
                # pack build, the only place a pack run still decodes
                reduce_for = (native_h, native_w) if fast else None
                means = []
                for fp in files:
                    img, gm = _decode_frame(fp, s, nearest=False,
                                            reduce_for=reduce_for)
                    if img.ndim == 2:
                        img = np.repeat(img[..., None], 3, axis=-1)
                    f.write(np.ascontiguousarray(img, np.uint8).tobytes())
                    means.append(round(gm, 4))
                index[name] = (start, len(files), int(native_h),
                               int(native_w), means)
                start += len(files)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    ip = index_path or path + ".index.json"
    # Crash-window discipline: drop any stale index BEFORE publishing the
    # new pack, publish the new index atomically AFTER. Every interruption
    # then leaves at most ONE of (pack, index) on disk, so the
    # exists-both rebuild guard (core/train.py) rebuilds instead of
    # silently pairing a new pack with a stale index's offsets.
    if os.path.exists(ip):
        os.remove(ip)
    os.replace(tmp, path)
    with open(ip + ".tmp", "w") as f:
        json.dump(index, f)
    os.replace(ip + ".tmp", ip)
    return index


class ClipPack:
    """Reader over a pack file: threaded native gather or memmap fallback."""

    def __init__(self, path: str, n_threads: int = 4):
        self.path = path
        self.n_threads = n_threads
        self._lib = _load_library()
        self._handle = 0
        if self._lib is not None:
            self._handle = self._lib.clippack_open(path.encode())
        if self._handle:
            info = (ctypes.c_int64 * 4)()
            self._lib.clippack_info(self._handle, info)
            self.n, self.h, self.w, self.c = (int(x) for x in info)
            self._mm = None
        else:
            header = np.fromfile(path, dtype=np.int64, count=5)
            # real raise, not assert: under `python -O` an assert would
            # silently memmap a non-pack file as frame data
            if header.size < 5 or header[0] != _MAGIC:
                raise ValueError(f"{path} is not a clip pack")
            self.n, self.h, self.w, self.c = (int(x) for x in header[1:5])
            if min(self.n, self.h, self.w, self.c) <= 0:
                raise ValueError(f"{path} has a corrupt pack header")
            # exact Python-int arithmetic (no int64 overflow) — mirrors the
            # native open()'s division-based coverage check
            need = self.n * self.h * self.w * self.c
            avail = os.path.getsize(path) - _HEADER_BYTES
            if need > avail:
                raise ValueError(
                    f"{path} truncated: header claims {need} frame bytes, "
                    f"file holds {avail}"
                )
            self._mm = np.memmap(
                path, dtype=np.uint8, mode="r", offset=_HEADER_BYTES,
                shape=(self.n, self.h, self.w, self.c),
            )

    @property
    def using_native(self) -> bool:
        return bool(self._handle)

    def gather(self, frame_ids: np.ndarray) -> np.ndarray:
        """frame_ids [K] int → frames [K, H, W, C] uint8."""
        ids = np.ascontiguousarray(frame_ids, dtype=np.int64)
        if self._handle:
            out = np.empty((len(ids), self.h, self.w, self.c), np.uint8)
            rc = self._lib.clippack_gather(
                self._handle,
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(ids),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self.n_threads,
            )
            if rc != 0:
                raise IndexError("frame id out of range")
            return out
        # match the native path's bounds semantics: numpy would silently
        # wrap negative ids to frames from the END of the pack
        if len(ids) and (ids.min() < 0 or ids.max() >= self.n):
            raise IndexError("frame id out of range")
        return np.asarray(self._mm[ids])

    def close(self):
        if self._handle:
            self._lib.clippack_close(self._handle)
            self._handle = 0

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
