"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``timetuning_tpu_torch/csrc`` compile with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use, from the package's sources only, into
``timetuning_tpu_torch/_build/``. The library's file name carries a hash of
the sources and the compiler flags: an edited source builds a new library and
an unchanged one loads the existing file.

Nothing here runs at import: the CPU tests import every module, and neither
``nvcc`` nor a card is needed until a CUDA tensor reaches a kernel wrapper.

Each kernel has a plain-integer launch count, raised by its wrapper once per
launch, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: its source, the TPU kernel it replaces, and
    how many times its wrapper has launched it."""

    name: str
    source: str
    replaces: str
    launches: int = 0


KERNELS = {
    k.name: k for k in (
        Kernel("attention_block", "timetuning_tpu_torch/csrc/attention_block.cu",
               "timetuning_tpu/ops/fused_block.py:83"),
        Kernel("mlp_block", "timetuning_tpu_torch/csrc/mlp_block.cu",
               "timetuning_tpu/ops/fused_block.py:158"),
        Kernel("propagation", "timetuning_tpu_torch/csrc/propagation.cu",
               "timetuning_tpu/ops/propagation_pallas.py:50"),
        Kernel("preprocess", "timetuning_tpu_torch/csrc/preprocess.cu",
               "timetuning_tpu/ops/preprocess_pallas.py:113"),
    )
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "tt_attention_block": [_P] * 10 + [_I] * 4 + [_P],
    "tt_mlp_block": [_P] * 9 + [_I] * 3 + [_P],
    "tt_propagate_labels": [_P] * 4 + [_I] * 9 + [_F, _P],
    "tt_eval_preprocess": [_P, _P, _P, _I, _P, _P, _I] + [_F] * 6 + [_P]
    + [_I] * 4 + [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "the CUDA kernels need nvcc (CUDA toolkit) to build; none found "
            "on PATH or at /usr/local/cuda/bin/nvcc")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtimetuning_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library unless a library of these sources exists.
    Returns its path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sorted(CSRC_DIR.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.tt_error_string.argtypes = [ctypes.c_int]
            lib.tt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(kernel: str, fn: str, device: torch.device, *args) -> None:
    """Call the C entry point ``fn`` on ``device`` and its current PyTorch
    stream (passed last), raise on a nonzero CUDA error, count the launch."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        msg = lib.tt_error_string(err).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {err} ({msg})")
    KERNELS[kernel].launches += 1


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper's input check: every tensor is a CUDA tensor on one
    device. The wrappers take their plain versions only for CPU tensors."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name}: expected CUDA tensors on one device, got {t.device} "
                f"(first input on {dev})")
