"""The port's check on one card: the benchmark cells' entry points, and every
hand-written kernel against its plain version at the arguments those paths
hand it.

    python chip_smoke.py

Needs a CUDA card and nvcc. Each path runs with the kernels' launch counts
set to 0 just before it and read just after, and must launch its kernels:

* ``train``: ``core/train.run_training`` of the flagship at the train cell's
  width and batch (``tests/torch_dp_worker.driver_config``: dino-s16 at 224,
  128 clips of 4 frames), one epoch of 4 steps (eager, capture, replays) and
  its epoch-top save: K1, K2, K3, K11;
* ``train, pallas route`` and ``train, cross-rank form``: one flagship step
  (``torch_dp_worker.flagship``, 32 clips) with ``attn_impl="pallas"`` (K10)
  and one on the data axis of a one-rank gloo group (K11's cross-rank form);
* ``serve-s8-c25``, ``serve-g14reg-c25``, ``serve-v3-7b16-c8`` and
  ``serve-samh-c8``: the cells' serving programs (their drivers'
  ``export_program``: ``serve_export``, ``serve_export_dinov3`` or
  ``serve_export_sam``; the seeded weights, ``cli/export``,
  ``load_exported(graphed=True)``) on a clip of the cell's traffic, called
  3 times (eager, capture, replay).

The first call of each kernel's wrapper outside a graph capture is recorded
(its arguments copied), and after its path the wrapper is held against the
plain version on those arguments; the heads-of-80 core is recorded and held
in each of its two forms (``flash_relpos`` in a windowed block,
``flash_relpos.global`` in a global one); K3 reads lattice features of the same shape
(every dot product exact, so no near-tie of the top-k), as its kernel test
does. Beside it are printed the wrapper's device time, the plain version's,
PyTorch's library calls for the same function where there are some
(``library_ms``; the port uses none of them) and the least time the card
could take (``bound_ms``: ``benchmark/counts.least_s`` of its operations and
its bytes, each input read and the output written once).

The last lines are a JSON object of the kernels (``{"kernels": [...]}``, also
written to ``chiprun_out/chip_smoke.json``), the card's name and power limit,
and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import functools
import inspect
import json
import os
import shutil
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT / "tools"))

import card  # noqa: E402
import torch_dp_worker as worker  # noqa: E402
from benchmark import counts, counts_sam, generate, harness  # noqa: E402
from timetuning_tpu_torch.ops import attention as att  # noqa: E402
from timetuning_tpu_torch.ops import flash_attention as fa  # noqa: E402
from timetuning_tpu_torch.ops import fused_block as fb  # noqa: E402
from timetuning_tpu_torch.ops import kernel_lib  # noqa: E402
from timetuning_tpu_torch.ops import preprocess_cuda as pc  # noqa: E402
from timetuning_tpu_torch.ops import propagation_cuda as prc  # noqa: E402
from timetuning_tpu_torch.ops import sinkhorn as skm  # noqa: E402
from timetuning_tpu_torch.ops import sinkhorn_cuda as sk  # noqa: E402

# ---------------------------------------------------- what each path launches

PATH_KERNELS = {
    "train": ("attention_block", "mlp_block", "propagation", "sinkhorn"),
    "train, pallas route": ("mha",),
    "train, cross-rank form": ("sinkhorn_dp",),
    "serve-s8-c25": ("preprocess", "ln_dense", "flash_attention", "dense_residual",
                     "mlp_rows"),
    "serve-g14reg-c25": ("preprocess", "ln_wide_dense", "dense_residual", "swiglu_mlp"),
    "serve-v3-7b16-c8": ("preprocess", "ln_rope_dense", "flash_d128", "dense_residual",
                         "swiglu_mlp"),
    "serve-samh-c8": ("preprocess", "ln_window_dense", "ln_wide_dense", "flash_relpos",
                      "dense_residual", "mlp_wide"),
}

# ----------------------------------------- the wrappers and their plain forms


def _sinkhorn_plain(scores, epsilon, n_iters, valid, world_size, group=None):
    """K11's plain version: the matvec form (``ops/sinkhorn.sinkhorn``) of
    ``exp(scores / epsilon)``, over ``group`` where there is one."""
    q = torch.exp(scores.detach().float() / epsilon).t()
    return skm.sinkhorn(q, n_iters, group=group, world_size=world_size, valid=valid)


def _ln(x, ln_s, ln_b, eps=1e-6):
    return F.layer_norm(x, x.shape[-1:], ln_s.to(x.dtype), ln_b.to(x.dtype), eps=eps)


def _lin(y, w, b):
    return F.linear(y, w.t(), None if b is None else b.to(y.dtype))


def _lib_attention(x, ln_s, ln_b, w_qkv, b_qkv, w_proj, b_proj, num_heads):
    B, S, D = x.shape
    q, k, v = _lin(_ln(x, ln_s, ln_b), w_qkv, b_qkv).reshape(
        B, S, 3, num_heads, D // num_heads).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B, S, D)
    return x + _lin(o, w_proj, b_proj)


def _lib_mlp(x, ln_s, ln_b, w1, b1, w2, b2):
    return x + _lin(F.gelu(_lin(_ln(x, ln_s, ln_b), w1, b1)), w2, b2)


def _lib_swiglu(x, ln_s, ln_b, w12, b12, w3, b3, eps=1e-6):
    a, g = _lin(_ln(x, ln_s, ln_b, eps), w12, b12).chunk(2, dim=-1)
    return x + _lin(F.silu(a) * g, w3, b3)


def _lib_ln_rope_dense(x, ln_s, ln_b, w, b, cos, sin, num_heads, prefix, eps):
    B, S, D = x.shape
    h = _lin(_ln(x, ln_s, ln_b, eps), w, b).reshape(B, S, 3, num_heads, D // num_heads)
    qk = h[:, prefix:, :2]
    half = qk.shape[-1] // 2
    rot = torch.cat([-qk[..., half:], qk[..., :half]], dim=-1)
    c, s = cos[:, None, None].to(x.dtype), sin[:, None, None].to(x.dtype)
    qk = torch.cat([h[:, :prefix, :2], qk * c + rot * s], dim=1)
    return torch.cat([qk, h[:, :, 2:]], dim=2).reshape(B, S, 3 * D)


def _lib_sdpa(q, k, v, kv_len=None):
    return None if kv_len not in (None, k.shape[2]) else F.scaled_dot_product_attention(q, k, v)


def _lib_relpos(qkv, rel_h, rel_w, num_heads, grid, window):
    """SDPA with SAM's decomposed bias as an additive mask, the [N, H, S, S]
    bias made from the two tables' products; windows merged and cropped."""
    N, S, E = qkv.shape
    K, Dh = window or grid, E // 3 // num_heads
    q, k, v = qkv.view(N, S, 3, num_heads, Dh).permute(2, 0, 3, 1, 4)
    idx = fa.rel_index(K, qkv.device)
    rq = q.reshape(N, num_heads, K, K, Dh)
    bh = torch.einsum("nhyxc,ykc->nhyxk", rq, rel_h.to(q.dtype)[idx])
    bw = torch.einsum("nhyxc,xkc->nhyxk", rq, rel_w.to(q.dtype)[idx])
    bias = (bh[..., :, None] + bw[..., None, :]).reshape(N, num_heads, S, S)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias).transpose(1, 2)
    o = o.reshape(N, S, E // 3)
    return fa.grid_rows(o, grid, window) if window else o


# wrapper name: (its module, plain version, library composition or None)
WRAPPERS = {
    "attention_block_branch": (fb, fb.attention_block_xla, _lib_attention),
    "mlp_block_branch": (fb, fb.mlp_block_xla, _lib_mlp),
    "mlp_rows": (fb, fb.mlp_block_xla, _lib_mlp),
    "ln_dense_rows": (fb, fb.ln_dense_xla, lambda x, s, b, w, wb: _lin(_ln(x, s, b), w, wb)),
    "ln_rope_dense_rows": (fb, fb.ln_rope_dense_xla, _lib_ln_rope_dense),
    "ln_window_dense_rows": (fb, fb.ln_window_dense_xla,
                             lambda x, s, b, w, wb, grid, window: _lin(
                                 fa.window_rows(_ln(x, s, b), grid, window), w, wb)),
    "swiglu_rows": (fb, fb.swiglu_block_xla, _lib_swiglu),
    "dense_residual_rows": (fb, fb.dense_residual_xla, lambda y, x, w, b: x + _lin(y, w, b)),
    "flash_attention": (fa, lambda *a: att._heads_view(fa.flash_attention_xla(*a)), _lib_sdpa),
    "relpos_attention": (fa, fa.relpos_attention_xla, _lib_relpos),
    "attention_mha": (att, lambda *a: att._heads_view(att.attention_mha_plain(*a)), _lib_sdpa),
    "eval_preprocess_cuda": (pc, lambda *a: pc.eval_preprocess_plain(*a).contiguous(), None),
    "propagate_labels_batch_cuda": (prc, prc.propagate_labels_batch_plain, None),
    "sinkhorn_assignment_cuda": (sk, _sinkhorn_plain, None),
    "sinkhorn_assignment_dp_cuda": (
        sk, lambda s, e, n, group, ws, valid: _sinkhorn_plain(s, e, n, valid, ws, group), None),
}

# kernel: (atol, rtol, why) of got against want (K3 and K11's forms: below)
ATTN_KERNELS = ("flash_attention", "flash_d128", "mha", "flash_relpos")
BLOCK_TOL = (3e-2, 3e-2, "bf16 rounding at O(1)")
ATTN_TOL = {torch.bfloat16: (4e-3, 1e-2, "one bf16 ulp of the output"),
            torch.float32: (1e-5, 1e-4, "f32 sums in another order")}
TOL = {"preprocess": (2e-2, 0.0, "one bf16 ulp below 4"),
       "sinkhorn": (1e-8, 1e-4, "f32 sums in another order over the iterations"),
       "sinkhorn_dp": (1e-6, 0.0, "the cross-rank test's bound")}

SEEN: dict = {}          # kernel: (wrapper name, wrapper, positional args)
RESULTS: dict = {}


def _form(name: str, kernel: str, args) -> str:
    """The key a launch is recorded under: the kernel's name, and for the
    heads-of-80 core in a global block (``window`` 0) a form of its own."""
    return f"{kernel}.global" if name == "relpos_attention" and args[-1] == 0 else kernel


def _record(name, wrapper, *args, **kwargs):
    """The wrapper, with its arguments copied (all positional) on the first
    eager launch of each kernel (or form, ``_form``) it makes."""
    before = kernel_lib.launch_counts()
    out = wrapper(*args, **kwargs)
    if torch.cuda.is_current_stream_capturing():
        return out
    bound = inspect.signature(wrapper).bind(*args, **kwargs)
    bound.apply_defaults()
    new = [_form(name, k, bound.args) for k, v in kernel_lib.launch_counts().items()
           if v > before[k]]
    new = [k for k in new if k not in SEEN]
    if new:
        rec = (name, wrapper, [a.detach().clone() if torch.is_tensor(a) else a
                               for a in bound.args])
        SEEN.update({k: rec for k in new})
    return out


def install_recorders() -> None:
    """Route every wrapper through ``_record``: a ``kernel_entry``'s eager
    wrapper (its closure cell, so names imported elsewhere see it) and its
    custom op's CUDA kernel (what an exported program calls); module-level
    wrappers by attribute (their callers look them up at call time)."""
    for name, (mod, _, _) in WRAPPERS.items():
        entry = getattr(mod, name)
        if hasattr(entry, "op"):
            rec = functools.partial(_record, name, entry.kernel)
            cell = entry.__code__.co_freevars.index("kernel")
            entry.__closure__[cell].cell_contents = rec
            entry.op.register_kernel("cuda", rec)
        else:
            setattr(mod, name, functools.partial(_record, name, entry))


def _bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def _flops(kernel, args) -> float:
    """Operations of one call: each weight's product with the rows, the
    attention's two products (the heads-of-80 core's: the grid's queries
    against their window's keys and the two bias products, as
    ``counts_sam.attn_least_s``); K3 its affinities and top-k (counts)."""
    ts = [a for a in args if torch.is_tensor(a)]
    if kernel == "flash_relpos":
        (N, S, E), grid, window = ts[0].shape, args[-2], args[-1]
        K = window or grid
        frames = N // ((-(-grid // window)) ** 2 if window else 1)
        return counts_sam.attn_flops(frames * grid * grid, K * K, K, E // 3)
    if kernel == "propagation":
        (B, T, N, D), K = ts[0].shape, ts[1].shape[1]
        return counts.propagation_flops(B, T, N, D, K, *args[2:5])
    if kernel in ("flash_attention", "flash_d128", "mha"):
        B, H, Sq, Dh = ts[0].shape
        return 4.0 * B * H * Sq * ts[1].shape[2] * Dh
    rows = ts[0].numel() // ts[0].shape[-1]
    if kernel == "ln_rope_dense":      # its one weight; the RoPE tables are bytes
        ts = ts[:4]
    f = sum(2.0 * rows * w.shape[0] * w.shape[1] for w in ts[1:] if w.dim() == 2)
    if kernel == "attention_block":
        B, S, D = ts[0].shape
        f += 4.0 * B * S * S * D
    return f


def hold(form: str) -> None:
    """The kernel's wrapper against its plain version on the arguments
    recorded for ``form``; times and bound into ``RESULTS``."""
    name, wrapper, args = SEEN[form]
    kernel = form.split(".")[0]
    _, plain, lib = WRAPPERS[name]
    if kernel == "propagation":     # lattice features of the recorded shape
        f = args[0]
        lat = worker.lattice_features(np.random.default_rng(0), tuple(f.shape[:-1]), f.shape[-1])
        args = [torch.from_numpy(lat).to(f.device, f.dtype), *args[1:]]
    got, want = wrapper(*args), plain(*args)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if kernel == "propagation":
        close = float(torch.isclose(got, want, rtol=1e-4, atol=1e-5).float().mean())
        agree = float((got.argmax(-2) == want.argmax(-2)).float().mean())
        ok = close == 1.0 and agree >= 0.999
        tol = f"rtol=1e-4 atol=1e-5 on every value ({close:.6f}), argmax >= 99.9% ({agree:.6f})"
    else:
        if kernel in ATTN_KERNELS:
            atol, rtol, why = ATTN_TOL[got.dtype]
        else:
            atol, rtol, why = TOL.get(kernel, BLOCK_TOL)
        ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
        tol = f"atol={atol:g} rtol={rtol:g} ({why})"
    ms = card.cuda_ms(lambda: wrapper(*args))
    plain_ms = card.cuda_ms(lambda: plain(*args), warmup=1, reps=3)
    lib_ms = None
    if lib is not None and lib(*args) is not None:
        lib_ms = card.cuda_ms(lambda: lib(*args))
    kind = "bf16" if torch.bfloat16 in (got.dtype, args[0].dtype) else "f32"
    bound_ms = 1e3 * counts.least_s(_flops(kernel, args), _bytes(*args, got), kind)
    shapes = [list(a.shape) for a in args if torch.is_tensor(a)]
    RESULTS[form] = {"wrapper": name, "shapes": shapes, "max_abs_err": err, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms, "library_ms": lib_ms}
    lib_s = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    print(f"kernel {form} ({name} {shapes[0]}): max_abs_err={err:.3e} gate {tol}: "
          f"{'ok' if ok else 'FAILED'} | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {lib_s}, least {bound_ms:.4f} ms", flush=True)
    if not ok:
        raise AssertionError(f"{form}: the kernel disagrees with its plain version")


def run_path(path: str, fn, totals: dict) -> None:
    """``fn()`` with the launch counts set to 0 just before and read just
    after (added to ``totals``); fails where a kernel of the path was not
    launched; then holds the kernels first recorded on it."""
    seen = set(SEEN)
    torch.cuda.synchronize()
    kernel_lib.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    launched = {k: v for k, v in kernel_lib.launch_counts().items() if v}
    print(f"path {path}: launches {launched}", flush=True)
    missing = [k for k in PATH_KERNELS[path] if k not in launched]
    if missing:
        raise AssertionError(f"{path}: kernels not launched: {missing}")
    for k, v in launched.items():
        totals[k] = totals.get(k, 0) + v
    for k in list(SEEN):
        if k not in seen:
            hold(k)


# ------------------------------------------------------------------ the paths


def train(dev, work: str) -> None:
    from timetuning_tpu_torch.core.train import run_training

    B = 128
    r = run_training(worker.driver_config(dev, os.path.join(work, "train"), B, num_epochs=1,
                                          num_workers=4))
    if not (r["global_step"] == 4 and np.isfinite(r["final_loss"])):
        raise AssertionError(f"train: step {r['global_step']}, loss {r['final_loss']}")


def train_step(dev, **kw) -> None:
    _, _, _, state, step = worker.flagship(dev, torch.bfloat16, **kw)
    loss = float(step(state, worker.train_clips(32, dev, seed=1))[1]["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"train step {kw}: loss {loss}")


def serve(dev, work: str, cell_name: str) -> None:
    from benchmark.drivers import serve_export, serve_export_dinov3, serve_export_sam
    from benchmark.reference import dinov2, dinov3, sam, vit

    cell = harness.load_cell(ROOT, cell_name)
    cfg, tr = cell.config, cell.traffic
    export_program = serve_export.export_program
    if "global_attn_indexes" in cfg:
        ref, shape = sam, sam.SamShape.of(cfg)
        export_program = serve_export_sam.export_program
    elif "n_storage_tokens" in cfg:
        ref, shape = dinov3, dinov3.DinoV3Shape.of(cfg)
        export_program = serve_export_dinov3.export_program
    elif "n_registers" in cfg:
        ref, shape = dinov2, dinov2.DinoV2Shape.of(cfg)
    else:
        ref, shape = vit, vit.ViTShape.of(cfg)
    weights = ref.seeded_weights(shape, 1, dev)
    run = types.SimpleNamespace(config=cfg, work_dir=work, device=dev)
    program = export_program(run, weights, tr["frames"])
    del weights
    clip, _ = generate.clips(1, 1, tr["frames"], tr["height"], tr["width"],
                             tuple(tr["objects"]), tr["textured"], tr["background"], dev)
    x = torch.from_numpy(clip[0]).to(dev)
    outs = [program(x).clone() for _ in range(3)]
    if not (torch.equal(outs[0], outs[2]) and bool(torch.isfinite(outs[0].float()).all())):
        raise AssertionError(f"{cell_name}: the replay differs from the eager call")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = card.nvidia_smi()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    kernel_lib.library()
    install_recorders()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    totals: dict = {}
    paths = (("train", lambda: train(dev, work)),
             ("train, pallas route", lambda: train_step(dev, attn_impl="pallas")),
             ("serve-s8-c25", lambda: serve(dev, work, "serve-s8-c25")),
             ("serve-g14reg-c25", lambda: serve(dev, work, "serve-g14reg-c25")),
             ("serve-v3-7b16-c8", lambda: serve(dev, work, "serve-v3-7b16-c8")),
             ("serve-samh-c8", lambda: serve(dev, work, "serve-samh-c8")))
    for path, fn in paths:
        run_path(path, fn, totals)
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    with worker.single_rank_group():     # open while K11's cross-rank form is held
        run_path("train, cross-rank form",
                 lambda: train_step(dev, axis_name="data", world_size=1), totals)

    missing = [k for k in kernel_lib.KERNELS if k not in RESULTS]
    if missing:
        raise AssertionError(f"kernels held on no path: {missing}")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "timetuning_tpu"))
    if loaded:
        raise AssertionError(f"modules of JAX or of the JAX package were imported: {loaded}")
    line = {"kernels": [{"name": form, "source": k.source, "replaces": k.replaces,
                         "launches": totals.get(n, 0), **RESULTS[form]}
                        for n, k in kernel_lib.KERNELS.items()
                        for form in RESULTS if form.split(".")[0] == n]}
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    (ROOT / "chiprun_out" / "chip_smoke.json").write_text(json.dumps(line, indent=1))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
