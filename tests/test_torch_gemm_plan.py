"""The host-side plan of the port's GEMM tile (csrc/gemm_wgmma.cuh), which
``ops/fused_block.gemm_plan`` computes and hands to the kernels, over the
shapes the port runs; the widths the wrappers refuse; and the plan of the
attention block's core, which is kernel 10's (``ops/attention.mha_plan``).
All on the CPU: the plan is plain Python."""

import pytest
import torch

from timetuning_tpu_torch.ops import attention as at
from timetuning_tpu_torch.ops import fused_block as fb

H100_SMS = 132
# token rows of the port's main paths: 50 frames of ViT-S/16 at 224, the
# train step's 128 frames, 50 frames of ViT-S/8 at 448
ROWS = {"s16_eval": 50 * 197, "s16_train": 128 * 197, "s8_eval": 50 * 3137}
SHARED_MEMORY_BYTES = 227 * 1024


@pytest.mark.parametrize("M", sorted(ROWS.values()))
@pytest.mark.parametrize("N,K,ln", [
    (1152, 384, True),      # LN1 + qkv (K7, K1's first product)
    (384, 384, False),      # proj + residual (K8, K1's last)
    (1536, 384, True),      # LN2 + fc1 + GELU
    (384, 1536, False),     # fc2 + residual: wide where the rows fill the card
    (2304, 768, True),      # a ViT-B row: wider than a resident 128-row block
    (768, 768, False),
    (3072, 768, True),      # ViT-B's fc1
    (768, 3072, False),     # ViT-B's fc2: two wide units
])
def test_gemm_plan_covers_every_tile_once_within_shared_memory(M, N, K, ln):
    p = fb.gemm_plan(M, N, K, ln, H100_SMS)
    assert p.block_rows == (64 if ln and K > 512 else 128)
    # a long streamed K is wide where the wide blocks fill the card once
    wide = not ln and K >= 1024 and -(-M // 128) * -(-N // 384) >= H100_SMS
    assert p.unit_cols == (384 if wide else 128)
    assert p.n_units == -(-N // p.unit_cols) and 1 <= p.n_slices <= p.n_units
    assert p.items == -(-M // p.block_rows) * p.n_slices
    # the slices of a row block, as the kernel cuts them, cover each unit once
    edges = [s * p.n_units // p.n_slices for s in range(p.n_slices + 1)]
    assert edges[0] == 0 and edges[-1] == p.n_units
    assert all(b > a for a, b in zip(edges, edges[1:]))
    # a wide product is one item a unit: the rows of A are read once a unit
    if wide:
        assert p.n_slices == p.n_units
        assert 3 * (128 * 64 * 2 + 384 * 64 * 2) + 1024 <= SHARED_MEMORY_BYTES
    # a resident block of A leaves room for a ring of at least three W tiles
    # and the epilogue's boxes in a block's shared memory
    if ln:
        assert p.block_rows * K * 2 + 3 * 128 * 64 * 2 + 4 * 64 * 128 <= SHARED_MEMORY_BYTES


@pytest.mark.parametrize("name,N,K,ln,n_slices", [
    ("s8_eval", 1152, 384, True, 1),     # 1,226 row blocks: whole waves, one slice
    ("s8_eval", 384, 384, False, 1),
    ("s8_eval", 384, 1536, False, 1),    # wide: all 384 columns in one walk over K
    ("s8_eval", 1536, 384, True, 1),
    ("s16_eval", 1152, 384, True, 1),    # 77 row blocks: a cut repeats the prologue
    ("s16_eval", 384, 384, False, 1),
    ("s16_eval", 384, 1536, False, 3),   # 77 row blocks: by turns, a slice a tile
    ("s16_eval", 1536, 384, True, 1),
    ("s16_train", 1152, 384, True, 1),
    ("s16_train", 1536, 384, True, 2),   # 197 row blocks x 12 tiles: 394 items
    ("s16_train", 384, 384, False, 1),
    ("s16_train", 384, 1536, False, 1),  # 197 row blocks fill the card: wide
    ("s16_eval", 768, 3072, False, 2),   # ViT-B's fc2: a unit of 384 columns each
])
def test_gemm_plan_slices_at_the_main_paths_shapes(name, N, K, ln, n_slices):
    assert fb.gemm_plan(ROWS[name], N, K, ln, H100_SMS).n_slices == n_slices


@pytest.mark.parametrize("name,n_slices,plain", [
    ("s8_eval", 1, 1),      # 1,226 row blocks: whole waves
    ("s16_eval", 3, 1),     # 77 x 12 tiles = 924 = 7 an SM: two waves of four tiles
    ("s16_train", 2, 2),    # 197 row blocks: three waves of six
])
def test_gemm_plan_slices_of_fc1_with_the_gelu_epilogue(name, n_slices, plain):
    """The GELU tile costs a quarter more than a bias tile, which moves the
    77 row blocks of an eval group from one slice to three."""
    assert fb.gemm_plan(ROWS[name], 1536, 384, True, H100_SMS,
                        fb.EPI_GELU).n_slices == n_slices
    assert fb.gemm_plan(ROWS[name], 1536, 384, True, H100_SMS).n_slices == plain


def test_gemm_plan_cuts_few_row_blocks_to_fill_the_card():
    """The choice follows the card's SM count: ten row blocks are cut into
    all their nine tiles on 132 SMs and stay whole on a card of eight."""
    wide = fb.gemm_plan(1280, 1152, 384, True, H100_SMS)
    narrow = fb.gemm_plan(1280, 1152, 384, True, 8)
    assert (wide.n_slices, wide.items, narrow.n_slices) == (9, 90, 1)


def test_gemm_plan_cuts_a_streamed_block_only_where_l2_overflows():
    """A streamed A by turns (K < 1,024) is read again for every tile of its
    row block: from L2, if a wave's blocks fit their share of it."""
    assert fb.gemm_plan(ROWS["s8_eval"], 768, 768, False, H100_SMS).n_slices == 6
    assert 132 * 128 * 768 * 2 > fb.GEMM_L2_SHARE > 132 * 128 * 384 * 2
    # ten row blocks of K = 768 fit: the waves decide, as for any product
    assert fb.gemm_plan(1280, 768, 768, False, H100_SMS).n_slices == 6
    assert fb.gemm_plan(1280, 768, 768, False, 10).n_slices == 1
    # from K = 1,024 on a product that fills the card is wide and reads
    # nothing twice; 77 row blocks of K = 1,536 go by turns and overflow L2
    assert fb.gemm_plan(ROWS["s8_eval"], 384, 1536, False, H100_SMS).n_slices == 1
    small = fb.gemm_plan(ROWS["s16_eval"], 384, 1536, False, H100_SMS)
    assert (small.unit_cols, small.n_slices) == (128, 3)
    assert fb.gemm_plan(ROWS["s16_eval"], 384, 1536, False, 64).unit_cols == 384


@pytest.mark.parametrize("M,N,K,wide", [
    # DINOv2 ViT-g's w12 (2 x 4,096 columns, 22 units): 5 row blocks x 22 =
    # 110 blocks leave SMs idle, 6 x 22 = 132 fill the card once
    (640, 8192, 1536, False),
    (641, 8192, 1536, True),
    (129, 8192, 1536, False),
    (25 * 1029, 8192, 1536, True),
    # 2 x 1,024 columns, 6 units: 21 row blocks x 6 = 126, 22 x 6 = 132
    (2688, 2048, 1024, False),
    (2689, 2048, 1024, True),
    (100_000, 8192, 960, False),      # K under GEMM_WIDE_K: always by turns
])
def test_gemm_plan_swiglu_product_goes_wide_where_it_fills_the_card(M, N, K, wide):
    """The SwiGLU product is wide on the rule of the residual product: K >=
    1,024 and its row blocks x units of 384 columns fill the card's 132 SMs
    at least once; fewer go by turns in slices by waves. The bias epilogue
    (the streamed qkv) is never wide."""
    p = fb.gemm_plan(M, N, K, False, H100_SMS, fb.EPI_SWIGLU)
    assert (p.unit_cols == fb.GEMM_WIDE_COLS) == wide
    assert p.n_units == -(-N // p.unit_cols)
    assert (p.n_slices == p.n_units) if wide else 1 <= p.n_slices <= p.n_units
    assert p.items == -(-M // 128) * p.n_slices
    assert fb.gemm_plan(M, N, K, False, H100_SMS, fb.EPI_BIAS).unit_cols == fb.GEMM_TILE_COLS


@pytest.mark.parametrize("M,N,K,ln,match", [
    (100, 1152, 96, True, "multiple of 64"),      # K not a swizzle atom
    (100, 1152, 32, False, "multiple of 64"),
    (100, 12, 384, False, "multiple of 8"),
    (100, 1152, 1088, True, "K <= 1024"),
    (0, 1152, 384, True, "M=0"),
])
def test_gemm_plan_refuses_what_the_tile_does_not_take(M, N, K, ln, match):
    with pytest.raises(ValueError, match=match):
        fb.gemm_plan(M, N, K, ln, H100_SMS)


def test_dense_check_refuses_widths_off_the_swizzled_layout():
    """``_check_dense`` guards ln_dense_rows / dense_residual_rows on the
    card: the tile's K steps are 64 wide (one 128-byte swizzle atom)."""
    ok = torch.zeros(128, 8)
    fb._check_dense("ln_dense_rows", 128, ok)
    for D, w in ((96, torch.zeros(96, 8)), (128, torch.zeros(128, 12)),
                 (128, torch.zeros(64, 8))):
        with pytest.raises(ValueError, match="multiple of 64"):
            fb._check_dense("ln_dense_rows", D, w)


@pytest.mark.parametrize("S", [1, 64, 197, 208, 256, 257, 260, 577, 1024])
def test_attention_block_core_plan_is_kernel_10s(S, monkeypatch):
    """``attention_block_branch`` asks ``mha_plan`` for its core's plan: the
    one object, not a copy that could drift."""
    assert fb.mha_plan is at.mha_plan
    passes, keys = fb.mha_plan(S)
    assert (passes == 1) == (S <= 256)
    assert keys >= S and (keys in at.ONE_PASS_KEYS if passes == 1
                          else keys % at.TWO_PASS_CHUNK == 0 and keys - S < 128)


def test_attention_block_core_refuses_sequences_over_the_whole_sequence_limit():
    with pytest.raises(ValueError, match="at most 1024"):
        fb.mha_plan(at.WHOLE_SEQUENCE_TOKENS + 1)
