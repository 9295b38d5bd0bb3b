"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skipped without one. This file imports no jax, so it runs on a
machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from timetuning_tpu_torch.data.transforms import IMAGENET_MEAN, REFERENCE_STD
from timetuning_tpu_torch.ops import flash_attention as fa
from timetuning_tpu_torch.ops import fused_block as fb
from timetuning_tpu_torch.ops import kernel_lib
from timetuning_tpu_torch.ops import preprocess_cuda as pc
from timetuning_tpu_torch.ops import propagation_cuda as prc

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


@pytest.mark.parametrize("S", [1, 64, 197, 260])
def test_attention_block_kernel_matches_plain(dev, S):
    """Ragged sequence edges (1, 197, 260) and an exact tile (64); bound:
    bf16 rounding at O(1) values."""
    x, attn, _ = _block_inputs(dev, 3, S)
    got = fb.attention_block_branch(x, *attn, num_heads=6)
    want = fb.attention_block_xla(x, *attn, num_heads=6)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("S", [50, 197])
def test_mlp_block_kernel_matches_plain(dev, S):
    x, _, mlp = _block_inputs(dev, 3, S, seed=1)
    got = fb.mlp_block_branch(x, *mlp)
    want = fb.mlp_block_xla(x, *mlp)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


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
    (25, 3136, 12, 4),            # ViT-S/8 at 448: window rows in shared memory
    (4, 3136, 0, 7),              # dense rows in global memory
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


@pytest.mark.parametrize("h,w,s", [(480, 854, 224), (256, 256, 224), (60, 107, 28)])
def test_preprocess_kernel_matches_plain(dev, h, w, s):
    frames = torch.from_numpy(np.random.default_rng(h).integers(
        0, 256, (3, h, w, 3), dtype=np.uint8)).to(dev)
    got = pc.eval_preprocess_cuda(frames, s, IMAGENET_MEAN, REFERENCE_STD)
    want = pc.eval_preprocess_plain(frames, s, IMAGENET_MEAN, REFERENCE_STD,
                                    out_dtype=torch.float32)
    assert got.dtype == torch.bfloat16 and got.shape == (3, s, s, 3)
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
    fa.flash_attention(*_qkv(dev, torch.float32, 5, 7))
    assert kernel_lib.launch_counts() == {
        "attention_block": 1, "mlp_block": 1, "propagation": 1, "preprocess": 1,
        "flash_attention": 2, "ln_dense": 1, "dense_residual": 1, "mlp_rows": 1}


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x, attn, _ = _block_inputs(dev, 1, 10)
    with pytest.raises(ValueError, match="bf16"):
        fb.attention_block_branch(x.float(), *attn, num_heads=6)
    with pytest.raises(ValueError, match="64-wide"):
        fb.attention_block_branch(x, *attn, num_heads=4)
    with pytest.raises(ValueError, match="uint8"):
        pc.eval_preprocess_cuda(torch.zeros(1, 8, 8, 3, device=dev), 4,
                                IMAGENET_MEAN, REFERENCE_STD)
    q = torch.zeros(1, 2, 8, 32, device=dev)
    with pytest.raises(ValueError, match="64-wide"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="bf16 or all f32"):
        fa.flash_attention(*(t.half() for t in _qkv(dev, torch.float32, 4, 4)))
