"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``timetuning_tpu_torch/csrc`` compile with ``nvcc`` for
``sm_90a``, one ``nvcc`` process per source, all started together, and link
into one shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use, from the package's sources only, into
``timetuning_tpu_torch/_build/``. The library's file name carries a hash of
the sources and the compiler flags: an edited source builds a new library and
an unchanged one loads the existing file.

Nothing here runs at import: the CPU tests import every module, and neither
``nvcc`` nor a card is needed until a CUDA tensor reaches a kernel wrapper.

Each kernel has a plain-integer launch count, raised by its wrapper once per
launch, so a run can show that its main path went through the kernels; a
few counts of work inside launches (``WORK_COUNTS``) sit beside them.

``kernel_entry`` makes a wrapper's public function. Eagerly it calls the
wrapper itself, or, where an input requires grad, the wrapper inside an
autograd Function with the JAX package's backward (``plain_vjp``: the VJP
of the plain version, as every block kernel's ``custom_vjp`` there). While
``torch.export`` traces, it calls the wrapper registered as a
``torch.library`` custom op (namespace ``timetuning_tpu_torch``), whose fake
gives the output's shape, dtype and strides: FakeTensors have no
``data_ptr()``. An exported program holds the ops by name, so loading one
needs this registration, which ``register_ops`` makes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import importlib
import inspect
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
    "-Xcompiler", "-fPIC",
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
        Kernel("flash_attention", "timetuning_tpu_torch/csrc/flash_attention.cu",
               "timetuning_tpu/ops/flash_attention.py:47 and :154"),
        Kernel("ln_dense", "timetuning_tpu_torch/csrc/rows_block.cu",
               "timetuning_tpu/ops/fused_block.py:298"),
        Kernel("dense_residual", "timetuning_tpu_torch/csrc/rows_block.cu",
               "timetuning_tpu/ops/fused_block.py:308"),
        Kernel("mlp_rows", "timetuning_tpu_torch/csrc/mlp_block.cu",
               "timetuning_tpu/ops/fused_block.py:282"),
        Kernel("mha", "timetuning_tpu_torch/csrc/mha.cu",
               "timetuning_tpu/ops/attention.py:53"),
        Kernel("sinkhorn", "timetuning_tpu_torch/csrc/sinkhorn.cu",
               "timetuning_tpu/ops/sinkhorn_pallas.py:51 and :91"),
        Kernel("sinkhorn_dp", "timetuning_tpu_torch/csrc/sinkhorn.cu",
               "timetuning_tpu/ops/sinkhorn_pallas.py:51 and :91"),
        # DINOv2 ViT-g's 1,536-wide blocks, which no TPU kernel takes
        Kernel("ln_wide_dense", "timetuning_tpu_torch/csrc/rows_block.cu",
               "none: LN + qkv over rows wider than the prologue (K7's width)"),
        Kernel("swiglu_mlp", "timetuning_tpu_torch/csrc/mlp_block.cu",
               "none: DINOv2's SwiGLU MLP (K9's place in its blocks)"),
        # DINOv3 ViT-7B's blocks: LN1 + qkv with RoPE, heads of 128
        Kernel("ln_rope_dense", "timetuning_tpu_torch/csrc/rows_block.cu",
               "none: LN + qkv + 2-D RoPE (K7's place in DINOv3's blocks)"),
        Kernel("flash_d128", "timetuning_tpu_torch/csrc/flash_attention.cu",
               "timetuning_tpu/ops/flash_attention.py:47 at heads of 128"),
        # SAM ViT-H's blocks: LN1 + qkv into window order, heads of 80 with
        # the decomposed relative-position bias, the GELU MLP at D 1,280
        Kernel("ln_window_dense", "timetuning_tpu_torch/csrc/rows_block.cu",
               "none: LN + qkv of SAM's windowed blocks (K7's place)"),
        Kernel("flash_relpos", "timetuning_tpu_torch/csrc/flash_attention.cu",
               "timetuning_tpu/ops/flash_attention.py:47 at heads of 80, with SAM's bias"),
        Kernel("mlp_wide", "timetuning_tpu_torch/csrc/mlp_block.cu",
               "none: the GELU MLP over rows wider than K9's prologue"),
    )
}


# Plain-integer counts of work inside launches, raised by a wrapper from a
# launch's shape beside its launch count: the key tiles that the flash core
# (K5/6) in bf16 at heads of 32 and 64 walks, once for each (batch, head),
# and those of them whose softmax ran while a product was in flight
# (``flash_attention.key_tile_counts``); SAM's (sequence, head) pairs that
# the heads-of-80 core attended over a window and over the whole grid, and
# those of them that its resident form took (sequences of up to 16 x 16
# tokens); the padded rows of the windows that LN1 + qkv computed.
WORK_COUNTS = {"flash_key_tiles": 0, "flash_key_tiles_overlapped": 0,
               "relpos_windows": 0, "relpos_global": 0, "relpos_windows_resident": 0,
               "window_pad_rows": 0}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
    for name in WORK_COUNTS:
        WORK_COUNTS[name] = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def counts() -> dict[str, int]:
    """The launch counts and the work counts in one dict (what a
    ``runtime.CapturedCall`` takes back out of a capture and adds on each
    replay)."""
    return {**launch_counts(), **WORK_COUNTS}


def add_counts(delta: dict[str, int]) -> None:
    """Raise the counts named in ``delta`` (keys as ``counts()``'s) by its
    values."""
    for name, n in delta.items():
        if name in WORK_COUNTS:
            WORK_COUNTS[name] += n
        else:
            KERNELS[name].launches += n


def sm_count(device) -> int:
    """The SMs of the card ``device`` (a ``torch.device``, its name or its
    index; without an index the current card), queried once a card."""
    device = torch.device("cuda", device) if isinstance(device, int) else torch.device(device)
    return _sm_count(torch.cuda.current_device() if device.index is None else device.index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "tt_attention_block": [_P] * 10 + [_I] * 8 + [_P],
    "tt_mlp_block": [_P] * 9 + [_I] * 5 + [_P],
    "tt_mlp_fc1": [_P] * 6 + [_I] * 4 + [_P],
    "tt_mlp_fc2": [_P] * 5 + [_I] * 4 + [_P],
    "tt_propagate_labels": [_P] * 10 + [_I] * 15 + [_F, _P],
    "tt_propagate_plan": [_I] * 3 + [_P],
    "tt_eval_preprocess": [_P, _P, _P, _I, _P, _P, _I] + [_F] * 6 + [_P]
    + [_I] * 8 + [_P],
    "tt_flash_attention": [_P] * 4 + [_I] * 7 + [_L] * 12 + [_P],
    "tt_flash_attention_form": [_P] * 4 + [_I] * 7 + [_L] * 12 + [_P],
    "tt_ln_dense": [_P] * 6 + [_I] * 4 + [_P],
    "tt_dense_residual": [_P] * 5 + [_I] * 4 + [_P],
    "tt_ln_wide_dense": [_P] * 7 + [_I] * 4 + [_P],
    "tt_ln_rope_dense": [_P] * 9 + [_I] * 6 + [_F, _P],
    "tt_swiglu_mlp": [_P] * 10 + [_I] * 5 + [_F, _P],
    "tt_ln_window_dense": [_P] * 7 + [_I] * 6 + [_P],
    "tt_flash_relpos": [_P] * 7 + [_I] * 6 + [_L] * 12 + [_P],
    "tt_mlp_wide": [_P] * 10 + [_I] * 5 + [_P],
    "tt_gemm_route": [_I] * 6 + [_P],
    "tt_mha": [_P] * 4 + [_I] * 7 + [_L] * 12 + [_P],
    "tt_sinkhorn": [_P] * 4 + [_I] * 4 + [_F] * 2 + [_P],
    "tt_sinkhorn_plan": [_I, _I, _P],
    "tt_sinkhorn_dp": [_P] * 9 + [_I] * 6 + [_F] * 2 + [_P],
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
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    objs = [f"{tmp}.{src.stem}.o" for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(src)]
            for src, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]     # every compile ends first
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tmp}.so", *objs]
    try:
        for cmd, proc, (out, err) in zip(cmds, procs, outs):
            _check_nvcc(cmd, proc.returncode, out, err)
        proc = subprocess.run(link, capture_output=True, text=True)
        _check_nvcc(link, proc.returncode, proc.stdout, proc.stderr)
        os.replace(f"{tmp}.so", path)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return path


def _check_nvcc(cmd: list[str], rc: int, out: str, err: str) -> None:
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}\n{err}")


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


def launch(kernel: str | None, fn: str, device: torch.device, *args) -> None:
    """Call the C entry point ``fn`` on ``device`` and its current PyTorch
    stream (passed last), raise on a nonzero CUDA error, count the launch as
    ``kernel``'s (None: a part of a kernel called alone by a check or a
    timing tool, which counts for no kernel)."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        msg = lib.tt_error_string(err).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {err} ({msg})")
    if kernel is not None:
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


def requires_grad(*args) -> bool:
    """Grad mode is on and a tensor among ``args`` requires grad (a plain
    loop: it runs on every eager kernel call)."""
    if not torch.is_grad_enabled():
        return False
    for t in args:
        if getattr(t, "requires_grad", False):
            return True
    return False


def require_no_grad(name: str, *tensors: torch.Tensor | None) -> None:
    """The input check of a wrapper whose kernel JAX never differentiates
    (kernels 3, 4 and 11, which have no ``custom_vjp`` there): a launch
    returns a tensor with no ``grad_fn``, so an input that requires grad
    while grad mode is on would have its gradient dropped in silence. Raise
    instead; the caller runs these passes under ``torch.no_grad()``."""
    if requires_grad(*tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and this kernel has no backward "
            "(its result would carry no grad_fn); call it under "
            "torch.no_grad()")


class _PlainVJP(torch.autograd.Function):
    """The kernel's forward with the backward of its plain version: the
    inputs are saved, and the backward recomputes the plain version from
    them and takes its VJP, the cotangent cast first to the first input's
    dtype (``_attn_bwd``, ``_mlp_bwd``, ``_ld_bwd``, ``_dr_bwd``,
    ``timetuning_tpu/ops/fused_block.py:404-491``). Non-tensor arguments
    (a head count) pass through."""

    @staticmethod
    def forward(ctx, kernel, plain, *args):
        ctx.plain = plain
        ctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
        ctx.consts = [None if t else a for a, t in zip(args, ctx.is_tensor)]
        ctx.save_for_backward(*(a for a in args if isinstance(a, torch.Tensor)))
        return kernel(*args)

    @staticmethod
    def backward(ctx, g):
        saved = iter(ctx.saved_tensors)
        needs = ctx.needs_input_grad[2:]
        args, wrt = [], []
        with torch.enable_grad():
            for is_t, const, need in zip(ctx.is_tensor, ctx.consts, needs):
                if not is_t:
                    args.append(const)
                    continue
                t = next(saved).detach().requires_grad_(need)
                args.append(t)
                if need:
                    wrt.append(t)
            first = next(a for a, t in zip(args, ctx.is_tensor) if t)
            out = ctx.plain(*args)
        grads = iter(torch.autograd.grad(out, wrt, g.to(first.dtype),
                                         allow_unused=True))
        return (None, None, *(next(grads) if n else None for n in needs))


def plain_vjp(plain):
    """``grad`` of ``kernel_entry``: the kernel forward, the VJP of
    ``plain`` (same arguments) backward."""
    return lambda kernel, *args: _PlainVJP.apply(kernel, plain, *args)


NAMESPACE = "timetuning_tpu_torch"

# the modules whose import registers the custom ops of their wrappers
OP_MODULES = ("timetuning_tpu_torch.ops.fused_block",
              "timetuning_tpu_torch.ops.flash_attention",
              "timetuning_tpu_torch.ops.attention",
              "timetuning_tpu_torch.ops.preprocess_cuda")


def register_ops() -> None:
    """Register every kernel's custom op (importing the wrapper modules
    does it): what loading an exported program needs."""
    for name in OP_MODULES:
        importlib.import_module(name)


def kernel_entry(name: str, schema: str, fake, grad=None):
    """Decorate a kernel wrapper (CPU tensors: the plain version, CUDA
    tensors: the launch) into its public function, which calls

      * while ``torch.export`` traces: the custom op ``timetuning_tpu_torch::
        <name>`` (``schema``, the wrapper as its body, ``fake`` its fake);
      * where an input requires grad in grad mode: ``grad(wrapper, *args)``
        (``plain_vjp(plain)``, or a Function of the wrapper's own); with no
        ``grad`` (a kernel JAX never differentiates) the wrapper;
      * else the wrapper, directly.

    The wrapper stays reachable as ``.kernel`` and the op as ``.op``."""

    def wrap(kernel):
        op = torch.library.custom_op(f"{NAMESPACE}::{name}", kernel,
                                     mutates_args=(), schema=schema)
        op.register_fake(fake)
        sig = inspect.signature(kernel)

        def positional(args, kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            return bound.args

        @functools.wraps(kernel)
        def entry(*args, **kwargs):
            if torch.compiler.is_exporting():
                return op(*positional(args, kwargs))
            if grad is not None and requires_grad(*args, *kwargs.values()):
                return grad(kernel, *positional(args, kwargs))
            return kernel(*args, **kwargs)

        entry.kernel, entry.op = kernel, op
        return entry

    return wrap
