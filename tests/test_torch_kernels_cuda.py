"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skipped without one. This file imports no jax, so it runs on a
machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from timetuning_tpu_torch.data.transforms import IMAGENET_MEAN, REFERENCE_STD
from timetuning_tpu_torch.ops import attention as at
from timetuning_tpu_torch.ops import flash_attention as fa
from timetuning_tpu_torch.ops import fused_block as fb
from timetuning_tpu_torch.ops import kernel_lib
from timetuning_tpu_torch.ops import preprocess_cuda as pc
from timetuning_tpu_torch.ops import propagation_cuda as prc
from timetuning_tpu_torch.ops import sinkhorn as skm
from timetuning_tpu_torch.ops import sinkhorn_cuda as sk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)


def _block_inputs(dev, B, S, D=384, hidden=1536, seed=0):
    rng = np.random.default_rng(seed)

    def w(n_in, n_out):
        return _t(rng.standard_normal((n_in, n_out)) / np.sqrt(n_in), dev)

    def v(n, scale=0.1, base=0.0):
        return _t(base + scale * rng.standard_normal(n), dev)

    x = _t(rng.standard_normal((B, S, D)), dev, torch.bfloat16)
    attn = (v(D, base=1), v(D), w(D, 3 * D), v(3 * D), w(D, D), v(D))
    mlp = (v(D, base=1), v(D), w(D, hidden), v(hidden), w(hidden, D), v(D))
    return x, attn, mlp


@pytest.mark.parametrize("B", [1, 50])
@pytest.mark.parametrize("S", [1, 64, 197, 208, 256, 257, 260, 577, 1024])
def test_attention_block_kernel_matches_plain(dev, S, B):
    """Ragged sequence edges (1, 197, 260, 577), exact tiles (64, 256, 1024),
    every strip width of the one-pass core, both sides of its limit (256,
    257) and the two-pass core up to its longest sequence; one frame (fewer
    heads than the card has SMs: a block of the core owns one query tile)
    and the eval group's 50 (a block owns a head). Bound: bf16 rounding at
    O(1) values."""
    x, attn, _ = _block_inputs(dev, B, S)
    got = fb.attention_block_branch(x, *attn, num_heads=6)
    want = fb.attention_block_xla(x, *attn, num_heads=6)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("S", [50, 197])
def test_mlp_block_kernel_matches_plain(dev, S):
    x, _, mlp = _block_inputs(dev, 3, S, seed=1)
    got = fb.mlp_block_branch(x, *mlp)
    want = fb.mlp_block_xla(x, *mlp)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("B", [60, 128, 512])
def test_blocks_at_the_driver_shapes(dev, B):
    """Both branches at 197 tokens on the in-training eval's 60 frames and
    the driver step's 128 (32 clips) and 512 (128 clips); bound: bf16
    rounding at O(1) values."""
    x, attn, mlp = _block_inputs(dev, B, 197, seed=2)
    got = fb.attention_block_branch(x, *attn, num_heads=6)
    want = fb.attention_block_xla(x, *attn, num_heads=6)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)
    got = fb.mlp_block_branch(x, *mlp)
    want = fb.mlp_block_xla(x, *mlp)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("D,hidden", [(384, 1536), (768, 3072)])
@pytest.mark.parametrize("B,S", [(3, 1), (3, 50), (3, 197), (2, 1024),      # K2's
                                 (1, 63), (1, 64), (1, 65), (1, 127), (1, 129),
                                 (50, 197)])
def test_mlp_kernels_match_plain_at_block_edges_and_both_vit_widths(dev, B, S, D, hidden):
    """K2 and K9 (one source) at ViT-S's and ViT-B's widths: sequences of 1,
    50, 197 and 1,024 tokens, and rows on both sides of every block edge
    (64-row groups, 128-row blocks; 9,850 rows = 77 blocks). Bound: bf16
    rounding at O(1) values."""
    x, _, mlp = _block_inputs(dev, B, S, D=D, hidden=hidden, seed=B + S)
    want = fb.mlp_block_xla(x, *mlp)
    for kern in (fb.mlp_block_branch, fb.mlp_rows):
        got = kern(x, *mlp)
        assert got.shape == x.shape and torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


def _bf16_ulp(a, b):
    return torch.exp2(torch.floor(torch.log2(torch.maximum(a.abs(), b.abs()))) - 7)


@pytest.mark.parametrize("D,hidden", [(384, 1536), (768, 3072), (512, 2048)])
@pytest.mark.parametrize("M", [65, 9850])
def test_mlp_hidden_is_within_one_ulp_of_the_plain_hidden(dev, M, D, hidden):
    """The bf16 hidden of the first launch (LN2 + fc1 + the kernels' one-range
    GELU) against the plain hidden (erf GELU) on the same bf16 weights. The
    products are the same f32 sums in another order and the two GELUs are
    3e-7 apart, so a value differs where its rounding to bf16 flips, by one
    ulp of the hidden; and where a normalised value of the row itself rounds
    the other way (the kernel's rsqrtf against rsqrt: a few rows in a
    hundred), which moves the row's pre-activations by that value's ulp
    times its weight. Bound: every value within one bf16 ulp or two such
    flips of the largest normalised value under the largest weight, at most
    1e-3 of them differing at all (counted over 9,850 rows: in 65 rows one
    such row more or less decides the share)."""
    x, _, mlp = _block_inputs(dev, 1, M, D=D, hidden=hidden, seed=M)
    w = (mlp[0], mlp[1], mlp[2].bfloat16(), mlp[3])
    got = fb.mlp_hidden_rows(x, *w).float()
    want = fb.mlp_hidden_xla(x, *w).float()
    normed = fb._ln(x, w[0], w[1]).float().abs().max()
    flips = (2 * _bf16_ulp(normed, normed) * w[2].float().abs().max()).item()
    apart = (got - want).abs()
    over = apart > torch.clamp(_bf16_ulp(got, want), min=flips)
    assert not over.any(), (over.sum().item(), flips, got[over][:4], want[over][:4])
    if M > 1000:
        assert (apart > 0).float().mean().item() <= 1e-3


def test_mlp_launches_alone_compose_to_the_kernel(dev):
    """fc1 and fc2 launched apart give the bits of the one call, and count as
    no kernel's launch."""
    x, _, mlp = _block_inputs(dev, 2, 197, seed=5)
    kernel_lib.reset_launch_counts()
    hidden = fb.mlp_hidden_rows(x, *mlp[:4])
    out = fb.mlp_out_rows(hidden, x, *mlp[4:])
    assert not any(kernel_lib.launch_counts().values())
    assert torch.equal(out, fb.mlp_block_branch(x, *mlp))
    assert kernel_lib.launch_counts()["mlp_block"] == 1


def _dense_inputs(dev, M, N, K, seed):
    rng = np.random.default_rng(seed)
    x = _t(rng.standard_normal((1, M, K)), dev, torch.bfloat16)
    res = _t(rng.standard_normal((1, M, N)), dev, torch.bfloat16)
    ln = (_t(1 + 0.1 * rng.standard_normal(K), dev), _t(0.1 * rng.standard_normal(K), dev))
    w = _t(rng.standard_normal((K, N)) / np.sqrt(K), dev)
    return x, res, ln, w, _t(0.1 * rng.standard_normal(N), dev)


@pytest.mark.parametrize("K", [64, 384, 768, 1536])
@pytest.mark.parametrize("N", [8, 200, 1152])
@pytest.mark.parametrize("M", [1, 127, 129, 9850])
def test_dense_row_kernels_at_ragged_rows_and_columns(dev, M, N, K):
    """The GEMM tile at its edges: rows that do not fill a row block (1, 127,
    129; 9,850 = 77 blocks cut into slices), a last column tile of 8 and of 72
    columns (N = 8, 200), one K step and many, A resident at 128 rows
    (K <= 512) and at 64 rows (768) under the LayerNorm prologue, streamed
    without it (the prologue stops at K = 1,024; at 1,536 the LayerNorm pass
    feeds the streamed tile). Bound: bf16 rounding at O(1) values."""
    x, res, ln, w, b = _dense_inputs(dev, M, N, K, seed=M + N + K)
    pairs = [(fb.dense_residual_rows(x, res, w, b), fb.dense_residual_xla(x, res, w, b)),
             (fb.ln_dense_rows(x, *ln, w, b), fb.ln_dense_xla(x, *ln, w, b))]
    for got, want in pairs:
        assert got.shape == (1, M, N) and torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("M,N,K", [
    (16_897, 384, 1536),     # 133 row blocks, the last of one row: fc2's own widths
    (17_000, 200, 1024),     # a unit of two tiles, the second of 72 columns
    (17_000, 8, 1536),       # a unit of 8 columns
    (8_500, 456, 1024),      # two units, the second of 72 columns; 67 row blocks x 2
    (9_850, 768, 3072),      # ViT-B's fc2 at 77 row blocks
])
def test_wide_product_at_ragged_rows_and_columns(dev, M, N, K):
    """The wide form (a streamed product from K = 1,024 on whose blocks fill
    the card: 384 output columns a block in one walk over K) at its edges.
    Bound: bf16 rounding at O(1) values."""
    assert fb.gemm_plan(M, N, K, False, kernel_lib.sm_count(0)).unit_cols == fb.GEMM_WIDE_COLS
    x, res, _, w, b = _dense_inputs(dev, M, N, K, seed=M + N + K)
    got, want = fb.dense_residual_rows(x, res, w, b), fb.dense_residual_xla(x, res, w, b)
    assert got.shape == (1, M, N) and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("n_slices", [1, 2, 5, 9])
def test_dense_row_kernels_agree_under_every_slicing(dev, n_slices, monkeypatch):
    """Whatever plan the host hands over, the tiles of a row block are each
    computed once: every slicing gives the bits of one slice."""
    x, res, ln, w, b = _dense_inputs(dev, 300, 1152, 384, seed=3)
    want = fb.ln_dense_rows(x, *ln, w, b), fb.dense_residual_rows(x, res, w, b)
    monkeypatch.setattr(fb, "_slices", lambda *a: n_slices)
    got = fb.ln_dense_rows(x, *ln, w, b), fb.dense_residual_rows(x, res, w, b)
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    monkeypatch.setattr(fb, "_slices", lambda *a: 10)      # more than 9 tiles
    with pytest.raises(RuntimeError, match="invalid"):
        fb.ln_dense_rows(x, *ln, w, b)


@pytest.mark.parametrize("K,ln,epi", [
    (K, ln, epi) for ln, epi in ((True, 0), (True, 1), (False, 2), (False, 0), (False, 3))
    for K in (64, 384, 512, 576, 768, 1024, 1536) if not (ln and K > 1024)])
def test_gemm_plan_mirrors_the_tiles_own_route(dev, K, ln, epi):
    """``fused_block.gemm_plan``'s rows a block and columns a unit are the C
    side's (``tt::gemm::route``), whose ring has at least three stages and
    whose shared memory fits a block, for each epilogue (bias, GELU,
    residual, SwiGLU; the LayerNorm prologue stops at K = 1,024) and both
    forms (by turns; wide from K = 1,024 on for a streamed product with the
    residual or the SwiGLU epilogue, where the row blocks fill the card)."""
    import ctypes

    out = (ctypes.c_int * 5)()
    for M in (1000, 100_000):       # 8 and 782 row blocks: under and over a card's SMs
        assert kernel_lib.library().tt_gemm_route(int(ln), epi, M, 1152, K, 132, out) == 0
        plan = fb.gemm_plan(M, 1152, K, ln, 132, epi)
        assert (out[0], out[3]) == (plan.block_rows, plan.unit_cols)
        assert out[1] >= 3 and out[2] <= 227 * 1024
        assert out[4] == int(not ln and epi in (2, 3) and K >= 1024 and M > 1000)


def _swiglu_inputs(dev, M, D, Hd, seed):
    rng = np.random.default_rng(seed)
    x = _t(rng.standard_normal((1, M, D)), dev, torch.bfloat16)
    ln = (_t(1 + 0.1 * rng.standard_normal(D), dev), _t(0.1 * rng.standard_normal(D), dev))
    w12 = _t(rng.standard_normal((D, 2 * Hd)) / np.sqrt(D), dev)
    w3 = _t(rng.standard_normal((Hd, D)) / np.sqrt(Hd), dev)
    return x, (*ln, w12, _t(0.1 * rng.standard_normal(2 * Hd), dev), w3,
               _t(0.1 * rng.standard_normal(D), dev))


@pytest.mark.parametrize("M,D,Hd", [
    (1, 1536, 4096), (129, 1536, 4096),
    (2 * 1029, 1536, 4096),        # two frames of DINOv2 ViT-g at 448: wide w12
    (25 * 1029, 1536, 4096),       # a request: the wide w12 and w3 products
    (2500, 1536, 1280),            # wide w12 whose last unit holds two W tiles
    (3000, 1024, 1024),            # wide from K = 1,024, the last unit one tile
    (300, 1152, 512),              # a narrower pass and a hidden of 8 tiles
    (300, 2048, 576),              # the pass's widest rows; 9 tiles
    (200, 384, 1024),              # rows the prologue could hold
])
def test_swiglu_rows_match_plain(dev, M, D, Hd):
    """The SwiGLU MLP branch (the LayerNorm pass, the tile's SwiGLU form,
    w3 + residual) against ``swiglu_block_xla``, at ragged rows and the
    widths of DINOv2 ViT-g. Bound: bf16 rounding at O(1) values."""
    x, mlp = _swiglu_inputs(dev, M, D, Hd, seed=M + D)
    got, want = fb.swiglu_rows(x, *mlp), fb.swiglu_block_xla(x, *mlp)
    assert got.shape == x.shape and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("M,N", [(1, 8), (127, 200), (1029, 4608), (25 * 1029, 4608)])
def test_ln_wide_dense_matches_plain(dev, M, N):
    """LN + qkv at DINOv2 ViT-g's 1,536-wide rows: the LayerNorm pass and
    the streamed tile with the bias epilogue, against ``ln_dense_xla``.
    Bound: bf16 rounding at O(1) values."""
    x, _, ln, w, b = _dense_inputs(dev, M, N, 1536, seed=M + N)
    kernel_lib.reset_launch_counts()
    got = fb.ln_dense_rows(x, *ln, w, b)
    assert kernel_lib.launch_counts()["ln_wide_dense"] == 1
    torch.testing.assert_close(got.float(), fb.ln_dense_xla(x, *ln, w, b).float(),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("M", [130, 2 * 1029])     # by turns; wide
def test_swiglu_rows_reads_silu_of_the_first_half(dev, M):
    """A ``w12`` whose second half gives 1 everywhere leaves ``silu(a)``:
    the kernel pairs the halves as DINOv2 does (``a`` first), in both forms
    of the SwiGLU product."""
    x, (ln_s, ln_b, w12, b12, w3, b3) = _swiglu_inputs(dev, M, 1536, 4096, seed=4)
    w12[:, 4096:] = 0.0
    b12[4096:] = 1.0
    got = fb.swiglu_rows(x, ln_s, ln_b, w12, b12, w3, b3)
    h = torch.nn.functional.silu(fb._dot(fb._ln(x, ln_s, ln_b), w12[:, :4096]) + b12[:4096])
    want = fb.dense_residual_xla(h.to(torch.bfloat16), x, w3, b3)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


def test_swiglu_forms_give_the_same_bits(dev):
    """The two forms of the SwiGLU product run the same products in the same
    K order and the same epilogue arithmetic: the fewest rows that go wide
    give, on the rows they share, the bits of one row fewer by turns."""
    sms = kernel_lib.sm_count(0)
    M = (-(-sms // 22) - 1) * 128 + 1          # 22 wide units of DINOv2's w12
    forms = [fb.gemm_plan(m, 8192, 1536, False, sms, fb.EPI_SWIGLU).unit_cols
             for m in (M - 1, M)]
    assert forms == [fb.GEMM_TILE_COLS, fb.GEMM_WIDE_COLS]
    x, mlp = _swiglu_inputs(dev, M, 1536, 4096, seed=6)
    wide = fb.swiglu_rows(x, *mlp)
    turns = fb.swiglu_rows(x[:, :M - 1].contiguous(), *mlp)
    assert torch.equal(wide[:, :M - 1], turns)


# swiglu_rows once under torch.profiler; prints the names of the device
# kernels that ran, as JSON
_TRACE_SWIGLU = """
import json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from timetuning_tpu_torch.ops import fused_block as fb
M, D, Hd = int(sys.argv[1]), 1536, 4096
g = torch.Generator(device="cuda").manual_seed(5)
r = lambda *s: torch.randn(*s, device="cuda", generator=g)
x = r(1, M, D).bfloat16()
mlp = (1 + 0.1 * r(D), 0.1 * r(D), r(D, 2 * Hd) / D ** 0.5, 0.1 * r(2 * Hd),
       r(Hd, D) / Hd ** 0.5, 0.1 * r(D))
fb.swiglu_rows(x, *mlp)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    fb.swiglu_rows(x, *mlp)
    torch.cuda.synchronize()
print(json.dumps(sorted({e.name() for e in prof.profiler.kineto_results.events()
                         if e.device_type() == DeviceType.CUDA})))
"""


@pytest.mark.parametrize("M,wide", [(25 * 1029, True), (129, False)])
def test_swiglu_product_runs_in_the_form_its_plan_names(dev, M, wide):
    """In the device trace a request's 25 x 1,029 rows run the SwiGLU
    product as the wide form's kernel (``gemm_swiglu_kernel_wide``) and
    never by turns; 129 rows, too few to fill the card, go by turns. The
    trace is taken in a process of its own: with the session in this
    process, the span test of tests/test_torch_profiling.py, run later in
    the same process after the card paths, once found no device events."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    assert (fb.gemm_plan(M, 8192, 1536, False, kernel_lib.sm_count(0), fb.EPI_SWIGLU)
            .unit_cols == fb.GEMM_WIDE_COLS) == wide
    run = subprocess.run([sys.executable, "-c", _TRACE_SWIGLU, str(M)], capture_output=True,
                         text=True, timeout=600, cwd=Path(__file__).resolve().parents[1])
    assert run.returncode == 0, run.stderr[-2000:]
    names = [n for n in json.loads(run.stdout.splitlines()[-1]) if "gemm_swiglu_kernel" in n]
    assert names and all(("gemm_swiglu_kernel_wide" in n) == wide for n in names), names


@pytest.mark.parametrize("T,N,D,n_last,radius,topk", [
    (25, 196, 384, 4, 12, 5),     # the eval shape
    (7, 49, 64, 2, 1, 3),         # context wraps around, 7x7 grid
    (4, 16, 32, 7, 0, 5),         # no neighbourhood restriction
    (2, 36, 32, 1, 2, 40),        # k beyond the live row: keep everything
])
def test_propagation_kernel_matches_plain(dev, T, N, D, n_last, radius, topk):
    rng = np.random.default_rng(T)
    feats = _t(rng.standard_normal((2, T, N, D)), dev)
    seg0 = torch.softmax(_t(rng.standard_normal((2, 4, N)), dev) * 3, dim=1)
    kw = dict(n_last=n_last, radius=radius, topk=topk)
    got = prc.propagate_labels_batch_cuda(feats, seg0, **kw)
    want = prc.propagate_labels_batch_plain(feats, seg0, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("T,N,radius,n_last", [
    (25, 3136, 12, 4),            # ViT-S/8 at 448: 32x32 key boxes
    (4, 3136, 0, 7),              # no neighbourhood: the whole frame a box
])
def test_propagation_kernel_at_s8_patch_count(dev, T, N, radius, n_last):
    """56x56 patches; bound as above (f32 sums in another order)."""
    rng = np.random.default_rng(N + radius)
    feats = _t(rng.standard_normal((1, T, N, 384)), dev)
    seg0 = torch.softmax(_t(rng.standard_normal((1, 4, N)), dev) * 3, dim=1)
    kw = dict(n_last=n_last, radius=radius, topk=5)
    got = prc.propagate_labels_batch_cuda(feats, seg0, **kw)
    want = prc.propagate_labels_batch_plain(feats, seg0, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_propagation_kernel_at_the_eval_shape_in_both_input_types(dev, dtype):
    """ViT-S/16 at 224: two 25-frame clips of 14x14 patches, D 384, radius
    12, n_last 4, top-k 5. bf16 features are read as bf16 (exact products,
    f32 sums in another order), f32 ones through their TF32 split: bound as
    above; every row's argmax channel agrees."""
    rng = np.random.default_rng(196)
    feats = _t(rng.standard_normal((2, 25, 196, 384)), dev, dtype)
    seg0 = torch.softmax(_t(rng.standard_normal((2, 4, 196)), dev) * 3, dim=1)
    kw = dict(n_last=4, radius=12, topk=5)
    got = prc.propagate_labels_batch_cuda(feats, seg0, **kw)
    want = prc.propagate_labels_batch_plain(feats, seg0, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert bool((got.argmax(2) == want.argmax(2)).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_propagation_kernel_takes_tied_rows_through_the_dense_pass(dev, dtype):
    """A clip whose patches are three lattice vectors (every dot product
    exact): whole windows tie at the k-th value, more entries than a compact
    row holds, so rows go through the exact dense pass; counted, and equal
    to the plain version."""
    rng = np.random.default_rng(3)
    atoms = np.zeros((3, 64), np.float32)
    for a in atoms:
        a[rng.choice(64, 16, replace=False)] = rng.choice([-0.25, 0.25], 16)
    feats = _t(atoms[rng.integers(0, 3, (1, 6, 196))], dev, dtype)
    seg0 = torch.softmax(_t(rng.standard_normal((1, 4, 196)), dev) * 3, dim=1)
    kw = dict(n_last=3, radius=2, topk=5)
    got, overflow, _ = prc.propagate_labels_batch_stats(feats, seg0, **kw)
    want = prc.propagate_labels_batch_plain(feats, seg0, **kw)
    assert int(overflow.sum()) > 0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,h,w,D,radius,n_last,all_dense", [
    (25, 56, 56, 64, 0, 7, False),    # 56x56, no neighbourhood, n_last 7: rows of 25,088
    (4, 2, 130, 64, 0, 7, True),      # a box wider than a chunk of 128 keys
    (3, 3, 140, 64, 61, 2, True),     # a 130-patch box at radius 61
])
def test_propagation_kernel_dense_pass_at_any_row_length(dev, dtype, T, h, w, D,
                                                         radius, n_last, all_dense):
    """The exact dense pass keeps its rows in device memory, so no row
    length is refused: at 56x56 patches with no neighbourhood and 7 recent
    frames (patches of three lattice vectors, as above: whole frames tie at
    the k-th value) the tied rows take it; where the tile's key box is
    wider than a chunk every row takes it. Counted, and equal to the plain
    version (bound as above)."""
    rng = np.random.default_rng(w + radius)
    N = h * w
    if all_dense:
        f = rng.standard_normal((1, T, N, D))
    else:
        atoms = np.zeros((3, D), np.float32)
        for a in atoms:
            a[rng.choice(D, 16, replace=False)] = rng.choice([-0.25, 0.25], 16)
        f = atoms[rng.integers(0, 3, (1, T, N))]
    feats = _t(f, dev, dtype)
    seg0 = torch.softmax(_t(rng.standard_normal((1, 4, N)), dev) * 3, dim=1)
    kw = dict(n_last=n_last, radius=radius, topk=5, spatial_size=(h, w))
    got, overflow, _ = prc.propagate_labels_batch_stats(feats, seg0, **kw)
    want = prc.propagate_labels_batch_plain(feats, seg0, **kw)
    n = int(overflow.sum())
    assert n == (T - 1) * N if all_dense else n > 0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("h,w,radius", [(56, 56, 12), (14, 14, 12), (14, 14, 6),
                                        (7, 7, 1), (4, 8, 1), (56, 56, 0), (33, 20, 5),
                                        (2, 130, 0), (3, 140, 61)])
def test_propagation_tile_plan_mirrors_the_kernels(dev, h, w, radius):
    """``propagation_cuda.tile_plan`` is the C side's ``make_plan``."""
    assert prc.device_plan(h, w, radius) == prc.tile_plan(h, w, radius)


def _qkv(dev, dtype, Sq, Sk, seed=0, B=1, H=2):
    rng = np.random.default_rng(seed)
    return (_t(rng.standard_normal((B, H, Sq, 64)), dev, dtype),
            _t(rng.standard_normal((B, H, Sk, 64)), dev, dtype),
            _t(rng.standard_normal((B, H, Sk, 64)), dev, dtype))


# bf16: p rounds to bf16 against the running max in the kernel and against
# the row max in the plain softmax, then the output rounds once: one bf16
# ulp of the output (rtol 1e-2) plus the p-rounding difference, which a
# CPU emulation of the kernel's rounding puts below 4e-3 at these shapes
# (at most 0.43 of this bound). Dropping one key moves outputs by 5-8x the
# bound at S = 1,025 to 4,200. f32: the same f32 operations, summed in
# another order.
_FLASH_TOL = {torch.bfloat16: dict(atol=4e-3, rtol=1e-2),
              torch.float32: dict(atol=1e-5, rtol=1e-4)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [1, 64, 1025, 3137, 4200])
def test_flash_attention_kernel_matches_plain(dev, dtype, S):
    """4,200 is past the TPU kernel's single-pass bound of 4,096 keys."""
    q, k, v = _qkv(dev, dtype, S, S, seed=S)
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_xla(q, k, v)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **_FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Sq,Sk,kv_len", [(300, 1100, 1000), (97, 64, 1),
                                          (1100, 300, None)])
def test_flash_attention_kernel_uneven_and_masked(dev, dtype, Sq, Sk, kv_len):
    q, k, v = _qkv(dev, dtype, Sq, Sk, seed=Sq, B=2, H=3)
    got = fa.flash_attention(q, k, v, kv_len=kv_len)
    want = fa.flash_attention_xla(q, k, v, kv_len=kv_len)
    torch.testing.assert_close(got.float(), want.float(), **_FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Sq,Sk,kv_len", [
    (1, 40, None),                # one query, fewer keys than a tile
    (127, 63, None), (129, 300, None),      # either side of a 128-row block
    (200, 256, 128), (200, 256, 129),       # the mask on and just past a tile edge
    (129, 500, 1),                # one valid key
    (200, 256, None), (129, 256, 250),      # two tiles: the pipeline's prologue and epilogue
])
def test_flash_attention_kernel_block_and_tile_edges(dev, dtype, Sq, Sk, kv_len):
    """The edges of the bf16 kernel's tiling: 128 query rows a block (a last
    block of one row), 128 keys a tile, fewer keys than one tile (the rest
    arrives zero-filled and masked), a mask that ends on a tile edge (no
    ragged tile) or one key past it, and a single valid key."""
    q, k, v = _qkv(dev, dtype, Sq, Sk, seed=Sq + Sk, B=2, H=3)
    got = fa.flash_attention(q, k, v, kv_len=kv_len)
    want = fa.flash_attention_xla(q, k, v, kv_len=kv_len)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **_FLASH_TOL[dtype])


def test_flash_attention_kernel_three_warpgroup_blocks(dev):
    """A grid large enough that the bf16 kernel takes its 192-row blocks
    (120 of them, one wave, against 192 blocks of 128 rows): a ragged last
    block, queries != keys and a mask that ends inside a key tile."""
    q, k, v = _qkv(dev, torch.bfloat16, 900, 1100, seed=21, B=4, H=6)
    got = fa.flash_attention(q, k, v, kv_len=1000)
    want = fa.flash_attention_xla(q, k, v, kv_len=1000)
    torch.testing.assert_close(got.float(), want.float(), **_FLASH_TOL[torch.bfloat16])


def _qkv_views(dev, B, S, H, Dh, seed):
    """q, k, v as the [B, H, S, Dh] views of one [B, S, 3, H, Dh] qkv buffer."""
    qkv = _t(np.random.default_rng(seed).standard_normal((B, S, 3, H, Dh)), dev,
             torch.bfloat16)
    return tuple(qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))


@pytest.mark.parametrize("B,H,S,Dh", [
    (25, 6, 3137, 64),     # S/8 at 448: a request of the serving program (24 of 25 tiles overlap)
    (25, 24, 1029, 64),    # DINOv2 ViT-g at 448: a last tile of 5 keys
    (4, 12, 3137, 32),     # MoCo-v3 ViT-S/16 above 512 px: heads of 32
])
def test_flash_attention_kernel_at_the_serving_shapes(dev, B, H, S, Dh):
    """The pipelined key loop (each key tile's softmax under the p @ v of the
    tile before) on the strided qkv views of the serving programs' shapes;
    bound as the other bf16 cases."""
    q, k, v = _qkv_views(dev, B, S, H, Dh, seed=S + H)
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_xla(q, k, v)
    assert got.shape == q.shape and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **_FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("warpgroups", [2, 3])
@pytest.mark.parametrize("Sq,Sk,kv_len,Dh", [
    (3137, 3137, None, 64),     # many tiles
    (1029, 1029, None, 64),     # a ragged last tile of 5 keys
    (100, 128, None, 64),       # one tile: the prologue and the epilogue alone
    (300, 256, None, 64),       # two tiles, nothing between
    (300, 1100, 1000, 64),      # the mask ends inside the second-to-last of Sk's tiles
    (1025, 1025, 1000, 32),     # heads of 32
])
def test_flash_attention_kernel_in_either_warpgroup_form(dev, warpgroups, Sq, Sk, kv_len, Dh):
    """Each form of the bf16 core (2 consumer warpgroups a block, 232
    registers a thread; 3, 160), forced whatever the card's waves would
    pick, on the same inputs; bound as the other bf16 cases. A row's
    arithmetic does not depend on the form: the form the waves pick gives
    the same bits."""
    rng = np.random.default_rng(Sq + Sk + Dh)
    q = _t(rng.standard_normal((2, 6, Sq, Dh)), dev, torch.bfloat16)
    k, v = (_t(rng.standard_normal((2, 6, Sk, Dh)), dev, torch.bfloat16) for _ in range(2))
    kernel_lib.reset_launch_counts()
    got = fa.flash_attention_form(q, k, v, kv_len, warpgroups)
    assert not any(kernel_lib.counts().values())
    want = fa.flash_attention_xla(q, k, v, kv_len=kv_len)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **_FLASH_TOL[torch.bfloat16])
    assert torch.equal(got, fa.flash_attention(q, k, v, kv_len=kv_len))


def test_graph_replays_raise_the_flash_tile_counts(dev):
    """A ``CapturedCall`` replay raises the flash core's key-tile counts as it
    raises its launch count, by what one eager call raises: at 3,137 keys 24
    of each (batch, head)'s 25 tiles overlap."""
    from timetuning_tpu_torch.runtime import CapturedCall

    q, k, v = _qkv_views(dev, 2, 3137, 6, 64, seed=3)
    graphed = CapturedCall(lambda q, k, v: fa.flash_attention(q, k, v))
    kernel_lib.reset_launch_counts()
    want = fa.flash_attention(q, k, v)
    eager = {name: n for name, n in kernel_lib.counts().items() if n}
    assert eager == {"flash_attention": 1, "flash_key_tiles": 2 * 6 * 25,
                     "flash_key_tiles_overlapped": 2 * 6 * 24}
    for call in range(3):      # eager on a side stream, capture + replay, replay
        kernel_lib.reset_launch_counts()
        got = graphed(q, k, v)
        assert {name: n for name, n in kernel_lib.counts().items() if n} == eager, call
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flash_attention_kernel_reads_strided_views_at_the_eval_batch(dev):
    """q, k, v as views of a [B, S, 3, H, 64] qkv buffer over several batch
    entries and heads: the tensor map's batch and head coordinates (126
    blocks of 192 rows here)."""
    B, S, H = 3, 1300, 6
    qkv = _t(np.random.default_rng(9).standard_normal((B, S, 3, H, 64)), dev,
             torch.bfloat16)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    assert at._aligned(q) is q and not q.is_contiguous()
    got = fa.flash_attention(q, k, v)
    assert got.permute(0, 2, 1, 3).is_contiguous()
    want = fa.flash_attention_xla(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), **_FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [1, 5, 64, 65, 128, 197, 208, 256, 257, 700, 1024])
def test_mha_kernel_strided_views_at_every_plan(dev, dtype, S):
    """Kernel 10 on the strided q, k, v views of a qkv buffer at each strip
    width of the one-pass plan (64, 128, 208, 256 keys), at a last query tile
    of one and of five rows (65, 197), on both sides of the one-pass limit
    (256, 257) and at a ragged and a full last chunk of the two-pass plan."""
    B, H = 3, 6
    qkv = _t(np.random.default_rng(S).standard_normal((B, S, 3, H, 64)), dev, dtype)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    got = at.attention_mha(q, k, v)
    want = at.attention_mha_plain(q, k, v)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **_FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [1, 197, 256, 1024])
def test_mha_kernel_matches_plain(dev, dtype, S):
    """Kernel 10 on contiguous q, k, v. bf16: one bf16 ulp of the output
    (rtol 1e-2) plus a p that rounds the other way because the kernel's row
    sum is accumulated tile by tile (atol 4e-3, as the flash kernel's
    bound); f32: the same f32 operations summed in another order."""
    q, k, v = _qkv(dev, dtype, S, S, seed=S, B=2, H=3)
    got = at.attention_mha(q, k, v)
    want = at.attention_mha_plain(q, k, v)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **_FLASH_TOL[dtype])


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("S", [1, 197, 256, 257, 785, 1024])
def test_mha_kernel_at_32_wide_heads(dev, S, B):
    """Kernel 10 in bf16 at MoCo-v3 ViT-S/16's twelve heads of 32 (64-byte
    rows in a 64-byte swizzle, p @ v as m64n32k16) on the strided views of
    a qkv buffer: one pass (1, 197, 256), both sides of its limit, and two
    passes (257, 785 = STEGO's ViT-S/8 at 224 or any S/16 at 448, 1,024);
    one frame (a block owns a query tile) and eight (a head). Bound as the
    64-wide rows."""
    qkv = _t(np.random.default_rng(S + B).standard_normal((B, S, 3, 12, 32)), dev,
             torch.bfloat16)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    got = at.attention_mha(q, k, v)
    want = at.attention_mha_plain(q, k, v)
    assert got.shape == q.shape and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **_FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Sq,Sk,kv_len", [(1025, 1025, None), (1090, 1090, 1025),
                                          (3137, 3137, 3120), (700, 1090, 1025),
                                          (129, 500, 1)])
def test_flash_attention_kernel_at_32_wide_heads(dev, dtype, Sq, Sk, kv_len):
    """Kernels 5/6 at MoCo-v3 ViT-S/16's twelve heads of 32 (bf16: 64-byte
    rows in a 64-byte swizzle, p @ v as m64n32k16; f32: the register tiles
    at Dh 32) on the strided views of a qkv buffer where Sq = Sk, with and
    without a key mask, queries != keys once, one valid key. Bound as the
    64-wide rows."""
    rng = np.random.default_rng(Sq + Sk)
    if Sq == Sk:
        qkv = _t(rng.standard_normal((2, Sq, 3, 12, 32)), dev, dtype)
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    else:
        q = _t(rng.standard_normal((2, 12, Sq, 32)), dev, dtype)
        k, v = (_t(rng.standard_normal((2, 12, Sk, 32)), dev, dtype) for _ in range(2))
    got = fa.flash_attention(q, k, v, kv_len=kv_len)
    want = fa.flash_attention_xla(q, k, v, kv_len=kv_len)
    assert got.shape == q.shape and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **_FLASH_TOL[dtype])


@pytest.mark.parametrize("S", [1, 197, 256, 257, 785, 1024])
def test_mha_kernel_at_32_wide_heads_in_f32(dev, S):
    """Kernel 10's f32 form at heads of 32 (the register tiles at Dh 32, a
    thread's output columns a float2): one pass up to 256 tokens, two
    above; bound as the 64-wide f32 rows."""
    qkv = _t(np.random.default_rng(S).standard_normal((8, S, 3, 12, 32)), dev)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    got = at.attention_mha(q, k, v)
    want = at.attention_mha_plain(q, k, v)
    torch.testing.assert_close(got, want, **_FLASH_TOL[torch.float32])


def test_custom_ops_launch_the_kernels_on_the_card(dev):
    """A kernel's custom op (what an exported program calls) on CUDA tensors
    launches the kernel, counted as the wrapper counts it, and returns what
    the eager wrapper returns, with the fake's strides."""
    x, attn, mlp = _block_inputs(dev, 2, 197)
    q, k, v = _qkv(dev, torch.bfloat16, 1030, 1030)
    for entry, args, name in (
            (fb.attention_block_branch, (x, *attn, 6), "attention_block"),
            (fb.mlp_block_branch, (x, *mlp), "mlp_block"),
            (fa.flash_attention, (q, k, v, 1000), "flash_attention")):
        kernel_lib.reset_launch_counts()
        got = entry.op(*args)
        assert kernel_lib.launch_counts()[name] == 1
        want = entry(*args)
        assert got.stride() == want.stride()
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("S", [1, 197, 256, 257, 785, 1024])
def test_attention_block_kernel_at_32_wide_heads(dev, S):
    """K1 at D = 384 with 12 heads of 32 (MoCo-v3 ViT-S/16): its core at
    Dh = 32 in one and two passes; bound: bf16 rounding at O(1) values."""
    x, attn, _ = _block_inputs(dev, 2, S, seed=S)
    got = fb.attention_block_branch(x, *attn, num_heads=12)
    want = fb.attention_block_xla(x, *attn, num_heads=12)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("B,S", [(2, 1), (50, 197), (2, 785)])
def test_blocks_at_vit_base_width(dev, B, S):
    """K1 and K2 at ViT-B's width (D 768, 12 heads of 64, hidden 3,072):
    dino-b16, vit and mocov3-b16; the eval group's 50 frames and a two-pass
    length. Bound: bf16 rounding at O(1) values."""
    x, attn, mlp = _block_inputs(dev, B, S, D=768, hidden=3072, seed=B + S)
    got = fb.attention_block_branch(x, *attn, num_heads=12)
    want = fb.attention_block_xla(x, *attn, num_heads=12)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)
    got = fb.mlp_block_branch(x, *mlp)
    want = fb.mlp_block_xla(x, *mlp)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


def test_mha_wrappers_raise_on_other_head_widths(dev):
    """Heads of 32 or 64 in bf16 and (since the f32 core took heads of 32)
    in f32: anything else raises on the card, never routed to the plain
    version."""
    for dh, dtype in ((48, torch.bfloat16), (16, torch.bfloat16), (48, torch.float32)):
        q = torch.zeros(1, 2, 8, dh, device=dev, dtype=dtype)
        with pytest.raises(ValueError, match="32- or 64-wide heads"):
            at.attention_mha(q, q, q)
    x, attn, _ = _block_inputs(dev, 1, 10)
    for heads in (4, 24):
        with pytest.raises(ValueError, match="64-wide"):
            fb.attention_block_branch(x, *attn, num_heads=heads)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mha_kernel_reads_strided_qkv_views_in_place(dev, dtype):
    """The q, k, v views that ``models/vit.Attention`` makes of its qkv rows:
    no copy on the way in, and the output is a view of the merged layout."""
    B, S, H = 3, 197, 6
    rng = np.random.default_rng(5)
    qkv = _t(rng.standard_normal((B, S, 3, H, 64)), dev, dtype)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    assert at._aligned(q) is q and not q.is_contiguous()
    got = at.attention_mha(q, k, v)
    assert got.permute(0, 2, 1, 3).is_contiguous()
    want = at.attention_mha_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), **_FLASH_TOL[dtype])


def test_attention_function_carries_gradients_through_the_kernel(dev):
    """impl="pallas": the forward is kernel 10, the backward the analytic
    recompute; against autograd through the plain version, f32."""
    q, k, v = _qkv(dev, torch.float32, 70, 70, seed=8)
    g = torch.randn_like(q)
    grads = []
    for fn in (lambda a, b, c: at.attention(a, b, c, impl="pallas")[0],
               lambda a, b, c: at.attention_xla(a, b, c)[0]):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        kernel_lib.reset_launch_counts()
        fn(*leaves).backward(g)
        grads.append([t.grad for t in leaves])
    assert kernel_lib.launch_counts()["mha"] == 0      # the plain pass ran last
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_attention_function_gradient_at_the_train_step_sequence(dev):
    """``_AttentionFused`` in bf16 at S = 197 (the one-pass plan at 208 keys)
    on strided views: the backward recomputes the probabilities in f32 from
    the saved bf16 q, k, v, as plain autograd does through ``attention_xla``,
    so the gradients differ by their final rounding to bf16 and by f32 sums
    taken in another order."""
    qkv = _t(np.random.default_rng(12).standard_normal((2, 197, 3, 6, 64)), dev,
             torch.bfloat16)
    g = torch.randn(2, 6, 197, 64, device=dev, dtype=torch.bfloat16)
    grads = []
    for fn in (lambda a, b, c: at.attention(a, b, c, impl="pallas")[0],
               lambda a, b, c: at.attention_xla(a, b, c)[0]):
        leaf = qkv.clone().requires_grad_(True)
        kernel_lib.reset_launch_counts()
        fn(*(leaf[:, :, i].permute(0, 2, 1, 3) for i in range(3))).backward(g)
        grads.append((leaf.grad, kernel_lib.launch_counts()["mha"]))
    (got, n_kernel), (want, n_plain) = grads
    assert (n_kernel, n_plain) == (1, 0)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=2e-2)


def _sinkhorn_inputs(dev, K, B, seed, with_valid):
    rng = np.random.default_rng(seed)
    Q = _t(np.exp(rng.uniform(-1, 1, (K, B)) / 0.05), dev)
    valid = _t(rng.uniform(size=B) > 0.3, dev) if with_valid else None
    return Q, valid


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("n_iters", [3, 10])
@pytest.mark.parametrize("K,B", [(200, 6272), (200, 25088), (8, 50), (200, 45000)])
def test_sinkhorn_kernel_matches_plain(dev, K, B, n_iters, with_valid):
    """Kernel 11 at the train step's two sizes, a tiny one and one whose
    slabs do not fit the SMs' shared memory (36 MB: the device-memory
    slabs). f32 sums in another order, compounded over the iterations."""
    Q, valid = _sinkhorn_inputs(dev, K, B, K + B + n_iters, with_valid)
    got = sk.sinkhorn_cuda(Q, n_iters, valid)
    want = sk.sinkhorn_plain(Q, n_iters, valid)
    assert got.shape == (B, K) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-8)


def _matvec_inputs(dev, K, B, seed, with_valid, zero_rows=False):
    Q, valid = _sinkhorn_inputs(dev, K, B, seed, with_valid)
    if zero_rows:
        Q[3] = 0.0                      # two underflowed prototypes
        Q[K - 1] = 0.0
        valid = torch.ones(B, device=dev) if valid is None else valid
        valid[5] = 0.0                  # a masked-out column
    return Q, valid


@pytest.mark.parametrize("world_size", [1, 2])
@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("K,B", [(200, 6272), (200, 25088), (200, 22656), (200, 41472),
                                 (8, 50), (300, 1000), (1024, 700)])
def test_sinkhorn_entries_match_the_matvec_form(dev, K, B, with_valid, world_size):
    """Kernel 11's two entries (Q [K, B]; the step's scores [B, K] with the
    exponential in the load) against the matvec form, ops/sinkhorn.sinkhorn
    with no group: the step's shapes (32 and 128 clips, 32 clips with the
    queue, 128 clips with the queue: slabs in device memory), a tiny one, a
    K above 256 (32 rows a lane), the largest K. f32 sums in another order
    over 10 iterations."""
    rng = np.random.default_rng(K + B + world_size)
    scores = _t(rng.uniform(-1, 1, (B, K)), dev)
    valid = _t(rng.uniform(size=B) > 0.3, dev) if with_valid else None
    Q = torch.exp(scores / 0.05).t().contiguous()
    want = skm.sinkhorn(Q, 10, world_size=world_size, valid=valid)
    got_q = sk.sinkhorn_cuda(Q, 10, valid, world_size)
    got_s = sk.sinkhorn_assignment_cuda(scores, 0.05, 10, valid, world_size)
    for got in (got_q, got_s):
        assert got.shape == (B, K) and got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("n_iters", [0, 1, 10])
@pytest.mark.parametrize("K,B", [(200, 6272), (200, 41472), (40, 300)])
def test_sinkhorn_kernel_pins_zero_marginals(dev, K, B, n_iters):
    """Two all-zero rows of Q and a masked-out column: zeros there, no NaN,
    equal to the matvec form."""
    Q, valid = _matvec_inputs(dev, K, B, 7, False, zero_rows=True)
    got = sk.sinkhorn_cuda(Q, n_iters, valid)
    want = skm.sinkhorn(Q, n_iters, valid=valid)
    assert torch.isfinite(got).all()
    assert (got[:, 3] == 0).all() and (got[:, K - 1] == 0).all() and (got[5] == 0).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("K,B", [(200, 6272), (200, 25088), (200, 22656), (200, 41472),
                                 (8, 50), (1024, 700)])
def test_sinkhorn_plan_mirrors_the_kernels(dev, K, B):
    plan, clusters = sk.device_plan(K, B)
    assert plan == sk.sinkhorn_plan(K, B, clusters)


@pytest.mark.parametrize("n_iters", [0, 1, 10])
@pytest.mark.parametrize("K,B,with_valid", [
    (200, 6272, False), (200, 6272, True), (200, 1, True), (200, 17, True),
    (200, 1000, True), (8, 50, True), (300, 1000, True), (1024, 700, False)])
def test_sinkhorn_cross_rank_form_on_one_process_matches_the_matvec_form(
        dev, K, B, n_iters, with_valid):
    """Kernel 11's cross-rank chain with no group (no all-reduce between its
    launches) on scores [B, K] against the matvec form: the step's shape a
    rank, 1 to 1,000 columns with a mask, K above 256 (32 rows a lane), the
    largest K; and its launches, 1 + max(n_iters, 1)."""
    rng = np.random.default_rng(K + B + n_iters)
    scores = _t(rng.uniform(-1, 1, (B, K)), dev)
    valid = _t(rng.uniform(size=B) > 0.3, dev) if with_valid else None
    if valid is not None:
        valid[0] = 1.0
    Q = torch.exp(scores / 0.05).t().contiguous()
    want = skm.sinkhorn(Q, n_iters, valid=valid)
    kernel_lib.reset_launch_counts()
    got = sk.sinkhorn_assignment_dp_cuda(scores, 0.05, n_iters, valid=valid)
    torch.cuda.synchronize()
    assert kernel_lib.launch_counts()["sinkhorn_dp"] == sk.dp_launches(n_iters)
    assert got.shape == (B, K) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-8)


def test_sinkhorn_cross_rank_form_pins_zero_marginals(dev):
    """Two prototypes whose scores underflow exp(s / eps) to 0 and a
    masked-out column: zeros there, no NaN, equal to the matvec form."""
    rng = np.random.default_rng(7)
    scores = _t(rng.uniform(-1, 1, (6272, 200)), dev)
    scores[:, 3] = scores[:, 199] = -100.0
    valid = torch.ones(6272, device=dev)
    valid[5] = 0.0
    got = sk.sinkhorn_assignment_dp_cuda(scores, 0.05, 10, valid=valid)
    want = skm.sinkhorn(torch.exp(scores / 0.05).t(), 10, valid=valid)
    assert (got[:, 3] == 0).all() and (got[:, 199] == 0).all() and (got[5] == 0).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-8)


def test_sinkhorn_cross_rank_form_at_two_ranks_on_one_card(dev, tmp_path):
    """2 gloo ranks on this card: each rank's kernel 11 cross-rank form, and
    ``sinkhorn_assignment`` with the group (which routes to it: 11 launches
    a call, none of the one-process form), against the plain group form
    (the matvec form with the all-reduces) on the rank's columns: the
    step's [6,272, 200] a rank, with and without a mask, and 1 to 1,000
    columns a rank with a mask (K 8, 200, 300)."""
    from torch_dp_worker import spawn

    kernel_lib.library()                       # one build, before the ranks
    rng = np.random.default_rng(5)
    inputs = {}
    for key, (K, B, masked) in {"step": (200, 6272, False), "step/valid": (200, 6272, True),
                                "1": (200, 1, True), "17": (8, 17, True),
                                "1000": (300, 1000, True)}.items():
        s = rng.uniform(-1, 1, (2 * B, K)).astype(np.float32)
        v = (rng.uniform(size=2 * B) > 0.3).astype(np.float32) if masked else None
        if v is not None:
            v[0] = v[B] = 1.0
        inputs[key] = (s, v)
    ranks = spawn([dict(kind="sinkhorn", name="sk", inputs=inputs, device="cuda:0")],
                  str(tmp_path), 2, timeout=300, device="cuda:0")
    for r in ranks:
        assert not r["foreign_modules"]
        for key in inputs:
            got, want = r["sk"][key + "/kernel"], r["sk"][key]
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-8)
            assert torch.equal(r["sk"][key + "/route"], got)
            counts = r["sk"][key + "/launches"]
            assert counts["sinkhorn_dp"] == 2 * sk.dp_launches(10) and counts["sinkhorn"] == 0


def test_train_step_launches_the_sinkhorn_kernel_once(dev):
    """A small f32 step on the card: its assignment is kernel 11, once a
    step, equal to the matvec form on the step's own scores."""
    from timetuning_tpu_torch.core import timet as tt
    from timetuning_tpu_torch.core.optimizer import swav_optimizer
    from timetuning_tpu_torch.models.extractor import FeatureExtractor
    from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer

    vit = VisionTransformer(ViTConfig(patch_size=8, embed_dim=64, depth=3, num_heads=1,
                                      img_size=32))
    model = tt.TimeT(FeatureExtractor(vit, 64, (48, 24)), 8)
    model.init_weights(torch.Generator().manual_seed(0)).to(dev)
    cfg = tt.TimeTConfig(n_prototypes=8, spatial_resolution=4, num_epochs=1,
                         steps_per_epoch=10, frozen_trunk_blocks=1)
    opt, mask = swav_optimizer(model, lr=1e-3, unfreeze_layers=("blocks.1", "blocks.2"),
                               num_steps=10, opt_over_trainable=True)
    state = tt.init_state(model, cfg, opt, trainable_mask=mask)
    step = tt.make_train_step(model, cfg, opt, trainable_mask=mask,
                              opt_over_trainable=True)
    seen = []
    assign = tt.sinkhorn_assignment

    def recording(scores, *a, **kw):
        seen.append((scores, assign(scores, *a, **kw)))
        return seen[-1][1]

    tt.sinkhorn_assignment = recording
    try:
        clip = torch.randn(2, 3, 32, 32, 3, generator=torch.Generator().manual_seed(1))
        kernel_lib.reset_launch_counts()
        for _ in range(2):
            _, metrics = step(state, clip.to(dev))
        assert kernel_lib.launch_counts()["sinkhorn"] == 2
        assert torch.isfinite(metrics["loss"])
    finally:
        tt.sinkhorn_assignment = assign
    scores, q = seen[-1]
    want = skm.sinkhorn(torch.exp(scores / cfg.epsilon).t(), cfg.sinkhorn_iterations)
    torch.testing.assert_close(q, want, rtol=1e-4, atol=1e-8)


def test_kernel_wrappers_raise_on_inputs_that_require_grad(dev):
    """The wrappers of the kernels JAX never differentiates (K3, K11) raise
    on an input that requires grad and run under no_grad; the others (K1,
    K2, K5/6, K7, K8, K9, K10), which raised here before they had JAX's
    backward, now differentiate: their gradients equal autograd through the
    plain versions at bf16's bound (the backward recomputes the plain
    version; only the forward is the kernel's)."""
    x, attn, mlp = _block_inputs(dev, 1, 10)
    q, k, v = _qkv(dev, torch.bfloat16, 8, 8)
    Q, _ = _sinkhorn_inputs(dev, 8, 50, 0, False)
    calls = [
        lambda: sk.sinkhorn_cuda(Q.clone().requires_grad_(True), 3),
        lambda: prc.propagate_labels_batch_cuda(
            torch.randn(1, 3, 16, 32, device=dev, requires_grad=True),
            torch.rand(1, 2, 16, device=dev)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()
    xr, xs = _block_inputs(dev, 1, 1030)[0], x
    w_qkv, w_proj = attn[2].to(torch.bfloat16), attn[4].to(torch.bfloat16)
    cases = [
        (fb.attention_block_branch, fb.attention_block_xla, (xs, *attn), {"num_heads": 6}),
        (fb.mlp_block_branch, fb.mlp_block_xla, (xs, *mlp), {}),
        (fb.mlp_rows, fb.mlp_block_xla, (xr, *mlp), {}),
        (fb.ln_dense_rows, fb.ln_dense_xla, (xr, attn[0], attn[1], w_qkv, attn[3]), {}),
        (fb.dense_residual_rows, fb.dense_residual_xla, (xr, xr, w_proj, attn[5]), {}),
        (fa.flash_attention, fa.flash_attention_xla, (q, k, v), {}),
        (at.attention_mha, at.attention_mha_plain, (q, k, v), {}),
    ]
    for kern, plain, args, kw in cases:
        got_in = [a.clone().requires_grad_(True) for a in args]
        want_in = [a.clone().requires_grad_(True) for a in args]
        out = kern(*got_in, **kw)
        g = torch.randn(out.shape, device=dev, generator=torch.Generator(dev).manual_seed(3))
        got = torch.autograd.grad(out, got_in, g.to(out.dtype))
        want = torch.autograd.grad(plain(*want_in, **kw), want_in, g.to(out.dtype))
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), atol=4e-3, rtol=1e-2)


@pytest.mark.parametrize("S", [1025, 3137])
def test_row_kernels_match_plain(dev, S):
    """ln_dense, dense_residual and mlp_rows, and the flash attention branch
    they make with the flash core, against their plain versions; bound: bf16
    rounding at O(1) values."""
    x, attn, mlp = _block_inputs(dev, 2, S, seed=S)
    y = _t(np.random.default_rng(S).standard_normal((2, S, 384)), dev, torch.bfloat16)
    ln_s, ln_b, w_qkv, b_qkv, w_proj, b_proj = attn
    pairs = [
        (fb.ln_dense_rows(x, ln_s, ln_b, w_qkv, b_qkv),
         fb.ln_dense_xla(x, ln_s, ln_b, w_qkv, b_qkv)),
        (fb.dense_residual_rows(y, x, w_proj, b_proj),
         fb.dense_residual_xla(y, x, w_proj, b_proj)),
        (fb.mlp_rows(x, *mlp), fb.mlp_block_xla(x, *mlp)),
        (fb.attention_block_branch_flash(x, *attn, num_heads=6),
         fb.attention_block_xla(x, *attn, num_heads=6)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("h,w,s,n", [
    (480, 854, 224, 3), (256, 256, 224, 3), (60, 107, 28, 3),
    (480, 854, 224, 50), (480, 854, 448, 50),        # the eval group's two outputs
    (64, 64, 48, 3),
    (61, 103, 48, 2),         # rows of 309 bytes: no multiple of 16
    (33, 77, 17, 5),          # output rows of 51 values: no multiple of 8
    (90, 1400, 40, 2),        # 35 W taps: the kernel's generic form
    (224, 224, 224, 60),      # the in-training eval's Pascal batch: scale 1
])
def test_preprocess_kernel_matches_plain(dev, h, w, s, n):
    frames = torch.from_numpy(np.random.default_rng(h).integers(
        0, 256, (n, h, w, 3), dtype=np.uint8)).to(dev)
    got = pc.eval_preprocess_cuda(frames, s, IMAGENET_MEAN, REFERENCE_STD)
    want = pc.eval_preprocess_plain(frames, s, IMAGENET_MEAN, REFERENCE_STD,
                                    out_dtype=torch.float32)
    assert got.dtype == torch.bfloat16 and got.shape == (n, s, s, 3)
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=0)


def test_preprocess_kernel_reads_a_view_that_starts_off_16_bytes(dev):
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (3, 61, 103, 3), dtype=np.uint8)).to(dev)
    view = frames[1:]                       # 18,849 bytes in
    got = pc.eval_preprocess_cuda(view, 48, IMAGENET_MEAN, REFERENCE_STD)
    want = pc.eval_preprocess_plain(view, 48, IMAGENET_MEAN, REFERENCE_STD,
                                    out_dtype=torch.float32)
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=0)


def test_each_wrapper_counts_its_launches(dev):
    x, attn, mlp = _block_inputs(dev, 1, 10)
    kernel_lib.reset_launch_counts()
    fb.attention_block_branch(x, *attn, num_heads=6)
    fb.mlp_block_branch(x, *mlp)
    prc.propagate_labels_batch_cuda(torch.randn(1, 3, 16, 32, device=dev),
                                    torch.rand(1, 2, 16, device=dev))
    pc.eval_preprocess_cuda(torch.zeros(2, 40, 40, 3, dtype=torch.uint8, device=dev),
                            20, IMAGENET_MEAN, REFERENCE_STD)
    fb.attention_block_branch_flash(x, *attn, num_heads=6)   # ln_dense, flash,
    fb.mlp_rows(x, *mlp)                                      # dense_residual
    xw, swiglu = _swiglu_inputs(dev, 10, 1536, 512, seed=1)
    fb.swiglu_rows(xw, *swiglu)
    fb.ln_dense_rows(xw, *swiglu[:2], swiglu[4].t(), swiglu[3][:512])   # at D 1,536
    fa.flash_attention(*_qkv(dev, torch.float32, 5, 7))
    at.attention(*_qkv(dev, torch.bfloat16, 5, 5))            # auto: kernel 10
    at.attention(*_qkv(dev, torch.float32, 5, 5), impl="pallas")
    at.attention(*_qkv(dev, torch.float32, 5, 5))             # auto, f32: plain
    sk.sinkhorn_cuda(torch.rand(4, 9, device=dev), 2)
    sk.sinkhorn_assignment_cuda(torch.rand(9, 4, device=dev))
    skm.sinkhorn_assignment(torch.rand(9, 4, device=dev))    # no group: kernel 11
    skm.sinkhorn(torch.rand(4, 9, device=dev), 2)            # the matvec form
    sk.sinkhorn_assignment_dp_cuda(torch.rand(9, 4, device=dev), 0.05, 2)  # 1 + 2
    xr = torch.randn(1, 5 + 12, 256, device=dev).bfloat16()            # heads of 128, RoPE
    cos, sin = torch.ones(12, 128, device=dev), torch.zeros(12, 128, device=dev)
    fb.ln_rope_dense_rows(xr, torch.ones(256, device=dev), torch.zeros(256, device=dev),
                          torch.randn(256, 768, device=dev).bfloat16(), None, cos, sin, 2, 5)
    fa.flash_attention(*(torch.randn(1, 2, 9, 128, device=dev).bfloat16() for _ in range(3)))
    # SAM's: LN1 + qkv into window order (a 7 x 7 grid in windows of 3), the
    # heads-of-80 core with the bias over its 9 windows, the GELU MLP past D 1,024
    xs = torch.randn(1, 49, 128, device=dev).bfloat16()
    fb.ln_window_dense_rows(xs, torch.ones(128, device=dev), torch.zeros(128, device=dev),
                            torch.randn(128, 192, device=dev).bfloat16(), None, 7, 3)
    rel = torch.zeros(5, 80, device=dev).bfloat16()
    fa.relpos_attention(torch.randn(9, 9, 480, device=dev).bfloat16(), rel, rel, 2, 7, 3)
    xm = torch.randn(1, 10, 1088, device=dev).bfloat16()
    fb.mlp_rows(xm, torch.ones(1088, device=dev), torch.zeros(1088, device=dev),
                torch.randn(1088, 128, device=dev).bfloat16(), None,
                torch.randn(128, 1088, device=dev).bfloat16(), None)
    assert kernel_lib.launch_counts() == {
        "attention_block": 1, "mlp_block": 1, "propagation": 1, "preprocess": 1,
        "flash_attention": 2, "ln_dense": 1, "dense_residual": 1, "mlp_rows": 1,
        "mha": 2, "sinkhorn": 3, "sinkhorn_dp": 3, "ln_wide_dense": 1, "swiglu_mlp": 1,
        "ln_rope_dense": 1, "flash_d128": 1, "ln_window_dense": 1, "flash_relpos": 1,
        "mlp_wide": 1}


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x, attn, _ = _block_inputs(dev, 1, 10)
    with pytest.raises(ValueError, match="bf16"):
        fb.attention_block_branch(x.float(), *attn, num_heads=6)
    with pytest.raises(ValueError, match="64-wide"):
        fb.attention_block_branch(x, *attn, num_heads=4)
    with pytest.raises(ValueError, match="at most 1024"):
        fb.attention_block_branch(x.expand(1, 10, 384).repeat(1, 103, 1), *attn,
                                  num_heads=6)
    narrow = torch.zeros(1, 10, 96, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiple of 64"):
        fb.ln_dense_rows(narrow, torch.ones(96, device=dev), torch.zeros(96, device=dev),
                         torch.zeros(96, 8, device=dev), torch.zeros(8, device=dev))
    with pytest.raises(ValueError, match="uint8"):
        pc.eval_preprocess_cuda(torch.zeros(1, 8, 8, 3, device=dev), 4,
                                IMAGENET_MEAN, REFERENCE_STD)
    with pytest.raises(ValueError, match="K <= 1024"):
        sk.sinkhorn_assignment_cuda(torch.zeros(10, 1025, device=dev))
    q = torch.zeros(1, 2, 8, 48, device=dev)
    with pytest.raises(ValueError, match="32- or 64-wide"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="bf16 or all f32"):
        fa.flash_attention(*(t.half() for t in _qkv(dev, torch.float32, 4, 4)))


def test_apply_augment_card_against_host(dev):
    """The training augmentation on the card against the same function on
    the host, on the same drawn values (32 clips of 4 frames, a 256 buffer to
    224, native 480 x 854): matrix products and blend in f32 without TF32.
    Bound 3e-4 on the normalised output: the card's exp and sqrt may place
    a crop box one ulp (1.5e-5 px at 200 px) from the host's, which on
    noise frames (slope up to 1 a pixel) moves a value by 1.5e-5, times the
    jitter factor (up to 1.8) and 1 / std (4.4): 1.2e-4; the products'
    order adds a few ulps."""
    from timetuning_tpu_torch.data import transforms as tf

    cfg = tf.AugmentConfig()
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (32, 4, 256, 256, 3), dtype=np.uint8))
    sizes = torch.tensor([[480, 854]] * 32)
    gmeans = torch.from_numpy(rng.uniform(40, 200, (32, 4)).astype(np.float32))
    params = tf.draw_augment_params(torch.Generator().manual_seed(1), 32, 4, cfg)
    want, _ = tf.apply_augment(frames, params, cfg, sizes, gmeans)
    got, _ = tf.apply_augment(frames.to(dev), params, cfg, sizes.to(dev), gmeans.to(dev))
    assert got.is_cuda and got.shape == (32, 4, 224, 224, 3)
    assert (got.cpu() - want).abs().max().item() <= 3e-4


def test_device_prefetch_keeps_order_and_values(dev):
    """Batches copied on a side stream arrive in order and whole, also while
    the consumer's stream is busy."""
    from timetuning_tpu_torch.data.loader import device_prefetch, host_batch_to_device

    host = [np.full((64, 1024), i, np.float32) for i in range(8)]
    side = torch.cuda.Stream(dev)
    seen = []
    for i, x in enumerate(device_prefetch(host, lambda a: host_batch_to_device(a, dev),
                                          depth=3, stream=side)):
        torch.cuda._sleep(200_000)                 # the consumer is busy
        seen.append(float((x * 1.0).mean()))
        assert x.is_cuda
    assert seen == [float(i) for i in range(8)]


def test_kmeans_on_the_card(dev):
    """k-means and PCA on the card against the host on the same draws:
    well separated blobs, so the same assignments."""
    from timetuning_tpu_torch.ops import kmeans as km

    rng = np.random.default_rng(3)
    centers = rng.uniform(-6, 6, (5, 16))
    x = torch.from_numpy((centers[rng.integers(0, 5, 20000)]
                          + 0.3 * rng.standard_normal((20000, 16))).astype(np.float32))
    draws = km.kmeans_draws(torch.Generator().manual_seed(0), x.shape[0], 5, 3)
    want = km.kmeans(x, 5, draws=draws, n_iter=20, n_redo=3)
    got = km.kmeans(x.to(dev), 5, draws=draws, n_iter=20, n_redo=3)
    assert torch.equal(got.assignments.cpu(), want.assignments)
    assert torch.allclose(got.centroids.cpu(), want.centroids, rtol=1e-4, atol=1e-4)
    red = km.normalize_and_reduce(x.to(dev), 8)
    assert red.shape == (20000, 8) and torch.isfinite(red).all()


@pytest.mark.parametrize("block", [0, 1])
def test_moe_vit_blocks_under_the_block_kernels(dev, block):
    """A bf16 MoE ViT-S block at 8 x 197 tokens: the dense block 0 runs
    kernels 1 and 2, the MoE block 1 kernel 1 and its MoE branch in plain
    ops; each against its plain bf16 composition (``attn_impl="xla"``)
    within K1 / K2's bound (3e-2 + 3e-2 rel.), launches counted."""
    from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer

    vit = VisionTransformer(ViTConfig(embed_dim=384, depth=2, num_heads=6,
                                      dtype=torch.bfloat16, moe_every_k=2,
                                      n_experts=8)).init_weights(
        torch.Generator().manual_seed(0)).to(dev)
    x = torch.randn(8, 197, 384, generator=torch.Generator().manual_seed(1)).to(
        dev, torch.bfloat16)
    blk = vit.blocks[block]
    with torch.no_grad():
        kernel_lib.reset_launch_counts()
        got, _ = blk(x)
        torch.cuda.synchronize()
        counts = kernel_lib.launch_counts()
        want, _ = blk(x, attn_impl="xla")
    err = (got.float() - want.float()).abs()
    assert bool((err <= 3e-2 + 3e-2 * want.float().abs()).all()), float(err.max())
    assert counts["attention_block"] == 1
    assert counts["mlp_block"] == (1 if block == 0 else 0)
