"""DINOv3 ViT-7B/16 in the port (``dinov3-vit7b16``) against the plain
reference ``benchmark/reference/dinov3.py`` on seeded random weights, at
test widths on the CPU (D 256, 2 heads of 128, 2 blocks, 4 storage tokens,
patch 16) on a non-square 64 x 48 input (a 4 x 3 grid, so that a table with
y and x swapped fails): the features through ``get_backbone`` and through a
``cli/export`` round trip, the RoPE table against its formula, the prefix
left unrotated, the hub-layout load, the depth cut, the CPU forms of the new
kernel entries. The card tests hold the new kernels (the flash form at heads
of 128, the LayerNorm pass at 4,096-wide rows, LN + qkv with the RoPE
epilogue) to their plain versions at the cell's shapes and two
published-width blocks at 896 through the graphed serving program to the
reference. This file imports no JAX."""

import dataclasses
import io
import math

import pytest
import torch

from benchmark.reference import dinov3 as ref
from timetuning_tpu_torch.models import registry, vit
from timetuning_tpu_torch.ops import flash_attention as fa
from timetuning_tpu_torch.ops import fused_block as fb
from timetuning_tpu_torch.ops import kernel_lib

torch.set_num_threads(2)

TINY = ref.DinoV3Shape(patch=16, dim=256, depth=2, heads=2, hidden=ref.swiglu_hidden(256))
MEAN, STD = [0.485, 0.456, 0.406], [0.228, 0.224, 0.225]


def tiny_config(dtype=torch.float32, **kw):
    """``vit.dinov3_vit7b`` cut to TINY's widths and depth."""
    return dataclasses.replace(vit.dinov3_vit7b(dtype=dtype, **kw), embed_dim=TINY.dim,
                               depth=TINY.depth, num_heads=TINY.heads)


@pytest.fixture
def tiny_registry(monkeypatch):
    monkeypatch.setattr(registry, "dinov3_vit7b", tiny_config)


@pytest.fixture(scope="module")
def weights():
    return ref.seeded_weights(TINY, 3_000_000_021, "cpu")


@pytest.fixture
def hub_pth(tmp_path, weights):
    """The weights in the hub checkpoint's layout, ``mask_token`` with them."""
    path = tmp_path / "dinov3_vit7b16.pth"
    torch.save(weights, path)
    return str(path)


def _gap(got, want):
    """The worst token's ||got - want|| / ||want||."""
    d = torch.linalg.vector_norm(got.double() - want.double(), dim=-1)
    return float((d / torch.linalg.vector_norm(want.double(), dim=-1)).max())


def _images(n=2, h=64, w=48, seed=0):
    return torch.randn(n, h, w, 3, generator=torch.Generator().manual_seed(seed))


def _model(dtype=torch.float32, **kw):
    m = vit.VisionTransformer(dataclasses.replace(tiny_config(dtype), **kw))
    return m


def test_published_configuration_and_the_hidden_rule():
    c = vit.dinov3_vit7b()
    assert (c.patch_size, c.embed_dim, c.depth, c.num_heads) == (16, 4096, 40, 32)
    assert (c.n_registers, c.layerscale, c.ffn, c.qkv_bias) == (4, True, "swiglu64", False)
    assert (c.rope_base, c.ln_eps, c.register_name) == (100.0, 1e-5, "storage_tokens")
    assert vit.swiglu_hidden(4096, 3.0, 64) == ref.swiglu_hidden(4096) == 8192
    assert vit.swiglu_hidden(256, 3.0, 64) == TINY.hidden == 512
    with torch.device("meta"):
        m = vit.VisionTransformer(dataclasses.replace(c, depth=1))
    mlp = m.blocks[0].mlp
    assert (mlp.w12.out_features, mlp.w3.in_features) == (2 * 8192, 8192)
    assert m.blocks[0].attn.qkv.bias is None and not hasattr(m, "pos_embed")
    assert m.blocks[0].norm1.eps == m.norm.eps == 1e-5
    assert "dinov3-vit7b16" in registry.ALL_ARCHITECTURES and "dinov3-vit7b16" in registry.VIT_NAMES
    assert "dinov3-vit7b16" not in registry.ARCHITECTURES     # the JAX registry's names


def test_rope_table_matches_its_formula():
    """cos and sin of ``[2 pi y / p_j ..., 2 pi x / p_j ...]`` tiled twice,
    p_j = 100^(j / 32), patch (r, c) of a 4 x 3 grid at y = 2 (r + 1/2) / 4 -
    1, x = 2 (c + 1/2) / 3 - 1, in raster order; the reference's table is
    the same, and a table with y and x swapped is not."""
    per = vit.rope_periods(128, 100.0)
    assert torch.allclose(per, torch.tensor([100 ** (j / 32) for j in range(32)]), rtol=1e-6)
    cos, sin = vit.rope_table(per, 4, 3)
    assert cos.shape == sin.shape == (12, 128)
    for t, (r, c) in enumerate((r, c) for r in range(4) for c in range(3)):
        y, x = 2 * (r + 0.5) / 4 - 1, 2 * (c + 0.5) / 3 - 1
        ang = [2 * math.pi * v / p for v in (y, x) for p in per.tolist()]
        ang = torch.tensor(ang * 2)
        torch.testing.assert_close(cos[t], torch.cos(ang), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(sin[t], torch.sin(ang), rtol=1e-5, atol=1e-5)
    rc, rs = ref.rope_tables(ref.periods(ref.DinoV3Shape()), 4, 3)
    torch.testing.assert_close(rc, cos, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(rs, sin, rtol=1e-6, atol=1e-6)
    swapped, _ = vit.rope_table(per, 3, 4)
    assert (swapped - cos).abs().max() > 0.1


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5), (torch.bfloat16, 0.03)])
def test_features_through_get_backbone_match_the_reference(tiny_registry, hub_pth, weights,
                                                           dtype, bound):
    """The hub-layout ``.pth`` (``mask_token`` in it) through ``get_backbone``
    on the 4 x 3 grid: f32 within f32 summation order of the reference;
    bf16 (the kernels' plain versions on the CPU: the RoPE entry, the flash
    core's plain version, the SwiGLU entry) within bf16 rounding over two
    blocks (0.03 of a token's norm, as the other ViTs' two-block checks)."""
    bb = registry.get_backbone("dinov3-vit7b16", hub_pth, dtype=dtype, device="cpu")
    assert (bb.patch_size, bb.feature_dim, bb.drop_cls) == (16, TINY.dim, True)
    x = _images()
    with torch.no_grad():
        out = bb.module(x)
        feats, probs = bb.apply(x)
        want = ref.tokens(weights, x, TINY)
    assert out["grid"] == (4, 3) and probs is None
    assert feats.shape == (2, 12, TINY.dim)
    assert _gap(feats, want[:, 5:]) < bound
    assert _gap(out["registers"].float(), want[:, 1:5]) < bound


@pytest.mark.parametrize("fault", ref.FAULTS)
def test_reference_faults_move_the_features(weights, fault):
    """Each fault of the reference reads far from the features at these
    widths: what the cell's limit has to catch."""
    x = _images(seed=3)
    with torch.no_grad():
        bad = ref.features(weights, x, TINY, fault=fault)
        assert _gap(bad, ref.features(weights, x, TINY)) > 0.1


def test_grid_with_y_and_x_swapped_fails(weights):
    """A program whose table put x where y goes (the 4 x 3 grid read as 3 x
    4) reads far from the reference: the non-square grid sees it."""
    m = _model()
    registry.load_checked(m, weights, only_known=True)
    m.rope_embed.prepare(3, 4)              # the wrong grid's table under the right key
    m.rope_embed.grid = (4, 3)
    x = _images(seed=4)
    with torch.no_grad():
        got = m(x)["tokens"][:, 1:]
        want = ref.features(weights, x, TINY)
    assert _gap(got, want) > 0.05


def test_prefix_tokens_pass_unrotated():
    """The RoPE entry's plain version and the composition's ``rope_rows``:
    the CLS token and the registers (the first 5 rows) leave q and k as the
    product gives them, v is never rotated, and the patch rows are."""
    g = torch.Generator().manual_seed(7)
    B, S, D, H = 2, 5 + 12, 256, 2
    x = torch.randn(B, S, D, generator=g)
    ln = (1 + 0.1 * torch.randn(D, generator=g), 0.1 * torch.randn(D, generator=g))
    w = torch.randn(D, 3 * D, generator=g) / 16
    cos, sin = vit.rope_table(vit.rope_periods(128, 100.0), 4, 3)
    plain = fb.ln_dense_xla(x, *ln, w, None, 1e-5)
    got = fb.ln_rope_dense_rows(x, *ln, w, None, cos, sin, H, 5, 1e-5)
    torch.testing.assert_close(got[:, :5], plain[:, :5], rtol=0, atol=0)
    torch.testing.assert_close(got[:, :, 2 * D:], plain[:, :, 2 * D:], rtol=0, atol=0)
    assert (got[:, 5:, :2 * D] - plain[:, 5:, :2 * D]).abs().max() > 0.1
    heads = plain.reshape(B, S, 3, H, 128)[:, :, 0].permute(0, 2, 1, 3)
    want = fb.rope_rows(heads, cos, sin, 5)
    torch.testing.assert_close(got.reshape(B, S, 3, H, 128)[:, :, 0].permute(0, 2, 1, 3), want,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(want[:, :, :5], heads[:, :, :5], rtol=0, atol=0)


def test_hub_layout_round_trips_and_ignores_only_the_mask_token(weights):
    """``storage_tokens``, ``rope_embed.periods``, ``mlp.w1`` / ``w2`` /
    ``w3``, no qkv bias, no ``pos_embed``: the module's state dict is the
    hub's layout but ``mask_token``; a load stacks ``w1`` and ``w2`` into
    ``w12`` (``w1`` first, the ``a`` of ``silu(a) * b``) and ``state_dict``
    gives them back apart, equal."""
    m = _model()
    registry.load_checked(m, weights, only_known=True)
    sd = m.state_dict()
    assert set(sd) == set(weights) - {"mask_token"}
    for k, v in sd.items():
        assert torch.equal(v, weights[k]), k
    mlp = m.blocks[1].mlp
    assert torch.equal(mlp.w12.weight[:TINY.hidden], weights["blocks.1.mlp.w1.weight"])
    assert torch.equal(mlp.w12.bias[TINY.hidden:], weights["blocks.1.mlp.w2.bias"])
    with pytest.raises(KeyError, match="missing"):
        registry.load_checked(_model(), {k: v for k, v in weights.items()
                                         if k != "blocks.0.mlp.w2.weight"}, only_known=True)


def test_missing_periods_take_the_published_ones(tiny_registry, weights, tmp_path):
    """A file without ``rope_embed.periods`` loads with the published
    periods: the same features."""
    path = tmp_path / "no_periods.pth"
    torch.save({k: v for k, v in weights.items() if k != "rope_embed.periods"}, path)
    bb = registry.get_backbone("dinov3-vit7b16", str(path), device="cpu")
    torch.testing.assert_close(bb.module.rope_embed.periods, weights["rope_embed.periods"])


def test_depth_builds_that_many_blocks_and_a_short_file_needs_it(tiny_registry, weights,
                                                                 tmp_path):
    """``depth=k`` builds the first k blocks and the final norm (a file with
    more blocks loads its first k); a file of k blocks without ``depth``
    raises, as any checkpoint that misses a block does."""
    one = {k: v for k, v in weights.items() if not k.startswith("blocks.1.")}
    short = tmp_path / "short.pth"
    torch.save(one, short)
    with pytest.raises(KeyError, match="missing"):
        registry.get_backbone("dinov3-vit7b16", str(short), device="cpu")
    full = tmp_path / "full.pth"
    torch.save(weights, full)
    for path in (short, full):
        bb = registry.get_backbone("dinov3-vit7b16", str(path), device="cpu", depth=1)
        assert len(bb.module.blocks) == bb.module.config.depth == 1
        x = _images(seed=5)
        with torch.no_grad():
            got = bb.apply(x)[0]
        want = ref.features(weights, x, dataclasses.replace(TINY, depth=1))
        assert _gap(got, want) < 1e-5
    for bad in (0, 3):
        with pytest.raises(ValueError, match="depth"):
            registry.get_backbone("dinov3-vit7b16", str(full), device="cpu", depth=bad)
    with pytest.raises(ValueError, match="depth applies to the ViTs"):
        registry.get_backbone("resnet18", device="cpu", depth=2)


def test_export_round_trip_matches_the_reference(tiny_registry, hub_pth, weights):
    """``cli/export`` of the bf16 program at ``depth`` 1 (the RoPE entry a
    custom op in it, the tables its buffers: no table is computed in the
    graph) and ``load_exported`` on the CPU, against the reference's
    features of the same uint8 frames; bound: bf16 rounding."""
    from timetuning_tpu_torch.cli.export import export_features, load_exported

    blob, live, shape, _ = export_features("dinov3-vit7b16", hub_pth, batch_size=2,
                                           input_resolution=64, device="cpu", depth=1)
    program = torch.export.load(io.BytesIO(blob))
    ops = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {"timetuning_tpu_torch.ln_rope_dense_rows.default",
            "timetuning_tpu_torch.swiglu_rows.default",
            "timetuning_tpu_torch.flash_attention.default"} <= ops
    assert not ops & {"aten.cos.default", "aten.sin.default"}
    assert any(k.endswith("rope_embed.cos") for k in program.state_dict) or any(
        "rope_embed.cos" in k for k in program.constants)
    serve = load_exported(io.BytesIO(blob))
    frames = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = serve(frames)
        want = ref.features_u8(weights, frames, dataclasses.replace(TINY, depth=1), 64,
                               MEAN, STD)
        torch.testing.assert_close(got, live(frames), rtol=0, atol=0)
    assert got.shape == want.shape == (2, 16, TINY.dim)
    assert _gap(got, want) < 0.03


def test_entries_cpu_forms_are_their_compositions():
    """The RoPE entry and the SwiGLU entry at eps 1e-5 on CPU tensors: their
    plain versions, one rounding each."""
    g = torch.Generator().manual_seed(8)
    B, S, D, Hd = 2, 17, 256, 512
    x = torch.randn(B, S, D, generator=g).bfloat16()
    ln = (1 + 0.1 * torch.randn(D, generator=g), 0.1 * torch.randn(D, generator=g))
    w12 = torch.randn(D, 2 * Hd, generator=g) / 16
    b12 = 0.1 * torch.randn(2 * Hd, generator=g)
    w3 = torch.randn(Hd, D, generator=g) / 23
    b3 = 0.1 * torch.randn(D, generator=g)
    got = fb.swiglu_rows(x, *ln, w12, b12, w3, b3, 1e-5)
    a, b = (fb._dot(fb._ln(x, *ln, 1e-5), w12) + b12).chunk(2, dim=-1)
    want = fb.dense_residual_xla((torch.nn.functional.silu(a) * b).bfloat16(), x, w3, b3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(fb._ln(x, *ln, 1e-5).float(), fb._ln(x.float() * 1e-3, *ln).float())


def test_kernel_route_needs_eps_where_the_prologue_holds_its_own():
    """A block with LayerNorm eps 1e-5 routed to kernels whose prologue
    holds 1e-6 (a GELU MLP, no RoPE) raises rather than computing another
    norm."""
    blk = vit.Block(256, 2, 4.0, dtype=torch.bfloat16, ln_eps=1e-5)
    with pytest.raises(ValueError, match="eps"):
        blk(torch.zeros(1, 17, 256, dtype=torch.bfloat16))


def test_plans_of_the_new_products():
    """At a request's 8 x 3,141 rows every product is wide: qkv with the
    RoPE epilogue (32 units of three heads), proj and w3 (K 4,096 and 8,192)
    and the SwiGLU product (2 x 8,192 columns, 43 units of 384). On rows too
    few to fill the card the RoPE product goes by turns, a tile a head, in
    slices by waves among those whose wave of blocks fits the L2 share."""
    rows = 8 * 3141
    qkv = fb.gemm_plan(rows, 3 * 4096, 4096, False, 132, fb.EPI_ROPE)
    assert (qkv.unit_cols, qkv.n_units, qkv.n_slices) == (fb.GEMM_WIDE_COLS, 32, 32)
    few = fb.gemm_plan(4 * 128, 3 * 4096, 4096, False, 132, fb.EPI_ROPE)
    assert few.unit_cols == fb.GEMM_TILE_COLS and few.n_units == 96
    assert (-(-132 // few.n_slices) + 1) * 128 * 4096 * 2 <= fb.GEMM_L2_SHARE
    w12 = fb.gemm_plan(rows, 2 * 8192, 4096, False, 132, fb.EPI_SWIGLU)
    assert (w12.unit_cols, w12.n_units, w12.n_slices) == (fb.GEMM_WIDE_COLS, 43, 43)
    for N, K in ((4096, 4096), (4096, 8192)):
        assert fb.gemm_plan(rows, N, K, False, 132).unit_cols == fb.GEMM_WIDE_COLS
    fb._check_ln_width("ln_rope_dense_rows", 8192)
    # another eps than the warp-a-row pass's 1e-6 only past its 2,048
    fb._check_ln_width("swiglu_rows", 2112, 1e-5)
    with pytest.raises(ValueError, match="eps"):
        fb._check_ln_width("swiglu_rows", 2048, 1e-5)


def test_parallel_forwards_refuse_a_rope_vit():
    from timetuning_tpu_torch.parallel import pp, sp

    m = _model()

    class Mesh:
        coords, n_inner, n_outer, inner, inner_index = (0, 0), 2, 1, None, 0

    for fn in (sp.sp_forward_fn, pp.pp_forward_fn):
        with pytest.raises(ValueError, match="RoPE"):
            fn(m, Mesh()) if fn is sp.sp_forward_fn else fn(m, Mesh(), 1)


# ------------------------------------------------------------------ the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_flash_heads_of_128_match_plain(dev):
    """The flash form at heads of 128 on strided q, k, v views of a qkv
    buffer at the cell's [8, 32, 3,141, 128], counted as ``flash_d128``,
    against ``flash_attention_xla``; and a ragged, masked call. Bound: the
    heads-of-64 form's (one bf16 ulp of the output plus p's rounding);
    f32 at 128 raises."""
    g = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn(8, 3141, 3, 32, 128, device=dev, generator=g).bfloat16()
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    kernel_lib.reset_launch_counts()
    got = fa.flash_attention(q, k, v)
    assert kernel_lib.launch_counts()["flash_d128"] == 1
    assert kernel_lib.launch_counts()["flash_attention"] == 0
    want = fa.flash_attention_xla(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), atol=4e-3, rtol=1e-2)
    q2, k2, v2 = (torch.randn(2, 3, s, 128, device=dev, generator=g).bfloat16()
                  for s in (300, 1100, 1100))
    torch.testing.assert_close(fa.flash_attention(q2, k2, v2, kv_len=1000).float(),
                               fa.flash_attention_xla(q2, k2, v2, 1000).float(),
                               atol=4e-3, rtol=1e-2)
    with pytest.raises(ValueError, match="128-wide in bf16"):
        fa.flash_attention(q2.float(), k2.float(), v2.float())


@pytest.mark.cuda
@pytest.mark.parametrize("M,D,eps", [(25128, 4096, 1e-5), (77, 4096, 1e-5), (300, 2176, 1e-5),
                                     (5, 8192, 1e-6)])
def test_ln_pass_of_a_block_a_row_matches_plain(dev, M, D, eps):
    """The LayerNorm pass of a block a row at the cell's [25,128, 4,096]
    (eps 1e-5), just past the warp-a-row pass's 2,048 and at its widest
    rows, against ``_ln``: the same two-pass statistics and one rounding.
    Read through ``ln_rope_dense_rows`` with ``w`` three identities and
    tables that turn by 0: each third of its output is then the pass's
    output exactly (one nonzero term a sum, no rotation, no bias)."""
    g = torch.Generator(device=dev).manual_seed(M)
    x = (3 * torch.randn(1, M, D, device=dev, generator=g) + 1).bfloat16()
    ln = (1 + 0.1 * torch.randn(D, device=dev, generator=g),
          0.1 * torch.randn(D, device=dev, generator=g))
    w = torch.eye(D, device=dev, dtype=torch.bfloat16).repeat(1, 3)
    cos = torch.ones(M, 128, device=dev)
    got = fb.ln_rope_dense_rows(x, *ln, w, None, cos, torch.zeros_like(cos), D // 128, 0, eps)
    want = fb._ln(x, *ln, eps).float()
    for third in got.float().chunk(3, dim=-1):
        torch.testing.assert_close(third, want, atol=2e-2, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(8, 3141), (1, 69), (2, 5 + 12)])
def test_ln_rope_dense_matches_plain(dev, B, S):
    """LN1 + qkv + RoPE (the pass and ``gemm_rope_kernel``) at D 4,096 and
    32 heads of 128, counted as ``ln_rope_dense``, against
    ``ln_rope_dense_xla``: the cell's 8 x 3,141 rows and ragged ones. Bound:
    bf16 rounding at O(1) values, as the other tiles'."""
    D, H, prefix = 4096, 32, 5
    g = torch.Generator(device=dev).manual_seed(S)
    x = torch.randn(B, S, D, device=dev, generator=g).bfloat16()
    ln = (1 + 0.1 * torch.randn(D, device=dev, generator=g),
          0.1 * torch.randn(D, device=dev, generator=g))
    w = (torch.randn(3 * D, D, device=dev, generator=g) / 64).t().bfloat16()
    b = 0.1 * torch.randn(3 * D, device=dev, generator=g)
    n = S - prefix
    side = int(math.isqrt(n))
    grid = (side, n // side) if side * (n // side) == n else (n, 1)
    cos, sin = vit.rope_table(vit.rope_periods(128, 100.0).to(dev), *grid)
    kernel_lib.reset_launch_counts()
    got = fb.ln_rope_dense_rows(x, *ln, w, b, cos, sin, H, prefix, 1e-5)
    assert kernel_lib.launch_counts()["ln_rope_dense"] == 1
    want = fb.ln_rope_dense_xla(x, *ln, w, b, cos, sin, H, prefix, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
def test_rope_forms_give_the_same_bits(dev):
    """The two forms of the RoPE product run the same products in the same K
    order and the same epilogue: the fewest rows that go wide give, on the
    rows they share, the bits of one row fewer by turns."""
    D, H, prefix = 4096, 32, 5
    sms = kernel_lib.sm_count(0)
    M = (-(-sms // 32) - 1) * 128 + 1          # 32 wide units of qkv
    forms = [fb.gemm_plan(m, 3 * D, D, False, sms, fb.EPI_ROPE).unit_cols for m in (M - 1, M)]
    assert forms == [fb.GEMM_TILE_COLS, fb.GEMM_WIDE_COLS]
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(1, M, D, device=dev, generator=g).bfloat16()
    ln = (1 + 0.1 * torch.randn(D, device=dev, generator=g),
          0.1 * torch.randn(D, device=dev, generator=g))
    w = (torch.randn(3 * D, D, device=dev, generator=g) / 64).t().bfloat16()
    cos, sin = vit.rope_table(vit.rope_periods(128, 100.0).to(dev), M - prefix, 1)
    wide = fb.ln_rope_dense_rows(x, *ln, w, None, cos, sin, H, prefix, 1e-5)
    turns = fb.ln_rope_dense_rows(x[:, :M - 1].contiguous(), *ln, w, None, cos[:-1], sin[:-1],
                                  H, prefix, 1e-5)
    assert torch.equal(wide[:, :M - 1], turns)


@pytest.mark.cuda
def test_two_published_blocks_through_the_graphed_program(dev, tmp_path):
    """Two blocks at the published widths (D 4,096, 32 heads of 128, hidden
    8,192, 4 storage tokens, RoPE) at 896 (3,141 tokens) through
    ``get_backbone(depth=2)``, ``export_features(depth=2)`` and
    ``load_exported(graphed=True)``, against the f32 reference on the same
    frames: every product, norm and attention core in the port's kernels
    (one launch of each entry a block a call). Bound: bf16 rounding over two
    blocks (0.03 of a token's norm)."""
    from timetuning_tpu_torch.cli.export import export_features, load_exported

    shape = ref.DinoV3Shape(depth=2)
    weights = ref.seeded_weights(shape, 3_000_000_019, dev)
    pth = tmp_path / "v3.pth"
    torch.save({k: v.cpu() for k, v in weights.items()}, pth)
    blob, live, _, _ = export_features("dinov3-vit7b16", str(pth), batch_size=2,
                                       input_resolution=896, device="cuda", depth=2)
    del live
    (tmp_path / "v3.pt2").write_bytes(blob)
    serve = load_exported(str(tmp_path / "v3.pt2"), graphed=True)
    frames = torch.randint(0, 256, (2, 896, 896, 3), dtype=torch.uint8, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    for _ in range(2):
        serve(frames)                # eager, then the capture
    kernel_lib.reset_launch_counts()
    got = serve(frames)
    counts = kernel_lib.launch_counts()
    assert counts["ln_rope_dense"] == counts["flash_d128"] == counts["swiglu_mlp"] == 2
    assert counts["dense_residual"] == 2 and counts["flash_attention"] == 0
    want = ref.features_u8(weights, frames, shape, 896, MEAN, STD)
    assert got.shape == want.shape == (2, 3136, 4096)
    assert _gap(got, want) < 0.03
