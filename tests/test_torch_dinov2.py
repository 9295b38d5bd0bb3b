"""DINOv2 ViT-g/14 with registers in the port (``dinov2-g14-reg``) against
the plain reference ``benchmark/reference/dinov2.py`` on seeded random
weights, at test widths on the CPU (D 64, 2 blocks, heads of 32, the SwiGLU
hidden by DINOv2's rule, 4 registers): the features through
``get_backbone`` and through a ``cli/export`` round trip, the f32 plain
composition, the CPU forms of the new kernel entries, the position resize,
the hub-layout load. One card test runs two blocks at the published widths
at 448 through the graphed serving program. This file imports no JAX."""

import dataclasses
import io

import pytest
import torch

from benchmark.reference import dinov2 as ref
from benchmark.reference.dense import preprocess
from timetuning_tpu_torch.models import registry, vit
from timetuning_tpu_torch.ops import fused_block as fb
from timetuning_tpu_torch.ops import kernel_lib

torch.set_num_threads(2)

TINY = ref.DinoV2Shape(patch=14, dim=64, depth=2, heads=2, hidden=ref.swiglu_hidden(64),
                       registers=4, img_size=56)
MEAN, STD = [0.485, 0.456, 0.406], [0.228, 0.224, 0.225]


def tiny_config(dtype=torch.float32, **kw):
    """``vit.dinov2_giant_reg`` cut to TINY's widths and depth."""
    return dataclasses.replace(vit.dinov2_giant_reg(dtype=dtype, **kw), embed_dim=TINY.dim,
                               depth=TINY.depth, num_heads=TINY.heads,
                               img_size=TINY.img_size)


@pytest.fixture
def tiny_registry(monkeypatch):
    monkeypatch.setattr(registry, "dinov2_giant_reg", tiny_config)


@pytest.fixture(scope="module")
def weights():
    return ref.seeded_weights(TINY, 11, "cpu")


@pytest.fixture
def hub_pth(tmp_path, weights):
    """The weights in the hub checkpoint's layout, ``mask_token`` with them."""
    path = tmp_path / "dinov2_vitg14_reg.pth"
    torch.save(weights, path)
    return str(path)


def _gap(got, want):
    """The worst token's ||got - want|| / ||want||."""
    d = torch.linalg.vector_norm(got.double() - want.double(), dim=-1)
    return float((d / torch.linalg.vector_norm(want.double(), dim=-1)).max())


def _images(n=2, size=70, seed=0):
    return torch.randn(n, size, size, 3, generator=torch.Generator().manual_seed(seed))


def test_published_configuration_and_the_hidden_rule():
    c = vit.dinov2_giant_reg()
    assert (c.patch_size, c.embed_dim, c.depth, c.num_heads, c.img_size) == (14, 1536, 40, 24, 518)
    assert (c.n_registers, c.layerscale, c.ffn, c.pos_resize) == (4, True, "swiglu", "dinov2")
    assert vit.swiglu_hidden(1536) == ref.swiglu_hidden(1536) == 4096
    assert vit.swiglu_hidden(64) == TINY.hidden == 176
    with torch.device("meta"):
        mlp = vit.VisionTransformer(dataclasses.replace(c, depth=1)).blocks[0].mlp
    assert (mlp.w12.out_features, mlp.w3.in_features) == (2 * 4096, 4096)
    assert "dinov2-g14-reg" in registry.ALL_ARCHITECTURES and "dinov2-g14-reg" in registry.VIT_NAMES
    assert "dinov2-g14-reg" not in registry.ARCHITECTURES      # the JAX registry's names


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5), (torch.bfloat16, 0.03)])
def test_features_through_get_backbone_match_the_reference(tiny_registry, hub_pth, weights,
                                                           dtype, bound):
    """The hub-layout ``.pth`` (``mask_token`` in it) through ``get_backbone``:
    f32 within f32 summation order of the reference; bf16 (the kernels'
    plain versions on the CPU) within bf16 rounding over two blocks."""
    bb = registry.get_backbone("dinov2-g14-reg", hub_pth, dtype=dtype, device="cpu")
    assert (bb.patch_size, bb.feature_dim, bb.drop_cls) == (14, TINY.dim, True)
    x = _images()
    with torch.no_grad():
        feats, probs = bb.apply(x)
        want = ref.features(weights, x, TINY)
    assert feats.shape == want.shape == (2, 25, TINY.dim) and probs is None
    assert _gap(feats, want) < bound


def test_f32_plain_composition_keeps_the_registers_apart(weights):
    """``attn_impl="xla"``: CLS + patches under ``tokens`` and every entry of
    ``intermediates``, the registers under their own key, the probabilities
    over CLS + patches; all equal to the reference's tokens."""
    m = vit.VisionTransformer(dataclasses.replace(tiny_config(), attn_impl="xla"))
    registry.load_checked(m, weights, only_known=True)
    x = _images(seed=1)
    with torch.no_grad():
        out = m(x, want_attention=True, n_intermediates=2)
        want = ref.tokens(weights, x, TINY)
    R = TINY.registers
    torch.testing.assert_close(out["tokens"], torch.cat([want[:, :1], want[:, 1 + R:]], 1),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out["registers"], want[:, 1:1 + R], rtol=1e-5, atol=1e-5)
    assert [t.shape for t in out["intermediates"]] == [(2, 26, TINY.dim)] * 2
    assert out["attention"].shape == (2, TINY.heads, 26, 26)
    assert out["grid"] == (5, 5)


def test_export_round_trip_matches_the_reference(tiny_registry, hub_pth, weights):
    """``cli/export`` of the bf16 program (the SwiGLU entry a custom op in
    it) and ``load_exported`` on the CPU, against the reference's features
    of the same uint8 frames; bound: bf16 rounding over two blocks."""
    from timetuning_tpu_torch.cli.export import export_features, load_exported

    blob, live, shape, _ = export_features("dinov2-g14-reg", hub_pth, batch_size=2,
                                           input_resolution=70, device="cpu")
    program = torch.export.load(io.BytesIO(blob))
    ops = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert "timetuning_tpu_torch.swiglu_rows.default" in ops
    serve = load_exported(io.BytesIO(blob))
    frames = torch.randint(0, 256, (2, 70, 70, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = serve(frames)
        want = ref.features_u8(weights, frames, TINY, 70, MEAN, STD)
        torch.testing.assert_close(got, live(frames), rtol=0, atol=0)
    assert got.shape == want.shape == (2, 25, TINY.dim)
    assert _gap(got, want) < 0.03


@pytest.mark.parametrize("grid", [(5, 5), (3, 6), (4, 4)])
def test_position_resize_at_other_grids(weights, grid):
    """Bicubic with antialias, by size, to grids below, beside and at the
    stored 4 x 4 (which passes through unchanged)."""
    pos = weights["pos_embed"]
    got = vit.interpolate_pos_embed_dinov2(pos, *grid)
    want = ref.pos_embed_for(pos, *grid)
    assert got.shape == (1, 1 + grid[0] * grid[1], TINY.dim)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if grid == (4, 4):
        assert got is pos


def test_hub_layout_load_ignores_only_the_mask_token(tiny_registry, weights, tmp_path):
    m = vit.VisionTransformer(tiny_config())
    own = set(m.state_dict())
    assert set(weights) - own == {"mask_token"}
    assert {"register_tokens", "blocks.1.ls1.gamma", "blocks.1.ls2.gamma",
            "blocks.1.mlp.w12.weight", "blocks.1.mlp.w3.bias"} <= own
    short = {k: v for k, v in weights.items() if k != "blocks.0.ls2.gamma"}
    torch.save(short, tmp_path / "short.pth")
    with pytest.raises(KeyError, match="ls2.gamma"):
        registry.get_backbone("dinov2-g14-reg", str(tmp_path / "short.pth"), device="cpu")


def test_seeded_init_without_a_checkpoint(tiny_registry):
    """No ``model_path``: the registry's seeded init, registers drawn like
    the CLS token and LayerScale at 1."""
    m = registry.get_backbone("dinov2-g14-reg", device="cpu").module
    assert 0 < float(m.register_tokens.detach().std()) < 0.05
    assert all(bool((b.ls1.gamma == 1).all()) for b in m.blocks)


def _swiglu_args(D=64, Hd=128, seed=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 9, D, generator=g).bfloat16()
    return x, (1 + 0.1 * torch.randn(D, generator=g), 0.1 * torch.randn(D, generator=g),
               torch.randn(D, 2 * Hd, generator=g) / D ** 0.5, 0.1 * torch.randn(2 * Hd, generator=g),
               torch.randn(Hd, D, generator=g) / Hd ** 0.5, 0.1 * torch.randn(D, generator=g))


def test_swiglu_entry_cpu_form_is_its_composition():
    """``swiglu_rows`` on CPU tensors: LN2 in f32 rounded to bf16, the f32
    product with ``w12`` and bias, ``silu`` of the first half times the
    second rounded to bf16 once, the w3 product and the residual summed in
    f32 and rounded once; its gradient is the composition's."""
    x, (s, b, w12, b12, w3, b3) = _swiglu_args()
    h = fb._ln(x, s, b).float() @ w12 + b12
    hidden = (torch.nn.functional.silu(h[..., :128]) * h[..., 128:]).bfloat16()
    want = (x.float() + (hidden.float() @ w3 + b3)).bfloat16()
    assert torch.equal(fb.swiglu_rows(x, s, b, w12, b12, w3, b3), want)
    xg = x.float().requires_grad_()
    w12g = w12.clone().requires_grad_()
    fb.swiglu_rows(xg, s, b, w12g, b12, w3, b3).square().sum().backward()
    xr, w12r = x.float().requires_grad_(), w12.clone().requires_grad_()
    fb.swiglu_block_xla(xr, s, b, w12r, b12, w3, b3).square().sum().backward()
    torch.testing.assert_close(xg.grad, xr.grad)
    torch.testing.assert_close(w12g.grad, w12r.grad)


def test_ln_dense_entry_cpu_form_at_wide_rows():
    """K7's entry at D 1,536 (the LayerNorm pass + streamed tile on the
    card) is ``ln_dense_xla`` on the CPU."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(1, 5, 1536, generator=g).bfloat16()
    s, b = 1 + 0.1 * torch.randn(1536, generator=g), 0.1 * torch.randn(1536, generator=g)
    w, bias = torch.randn(1536, 64, generator=g) / 40, torch.randn(64, generator=g)
    assert torch.equal(fb.ln_dense_rows(x, s, b, w, bias), fb.ln_dense_xla(x, s, b, w, bias))


def test_wide_blocks_take_the_row_kernels_at_any_token_count(monkeypatch):
    """A bf16 block wider than the tile's LayerNorm prologue holds (D 1,152
    > 1,024) at 10 tokens routes to the row kernels (never K1/K2, which
    raise at that width), its SwiGLU MLP to ``swiglu_rows``; a GELU MLP that
    wide to ``mlp_rows`` (its wide route: SAM ViT-H's MLP), never K2."""
    routes = []
    for name in ("attention_block_branch", "attention_block_branch_flash",
                 "mlp_block_branch", "mlp_rows", "swiglu_rows"):
        fn = getattr(vit, name)
        monkeypatch.setattr(vit, name,
                            lambda *a, _n=name, _f=fn, **kw: routes.append(_n) or _f(*a, **kw))
    x = torch.randn(1, 10, 1152).bfloat16()
    block = vit.Block(1152, 18, 4.0, dtype=torch.bfloat16, layerscale=True, ffn="swiglu")
    with torch.no_grad():
        y, _ = block(x)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    assert routes == ["attention_block_branch_flash", "swiglu_rows"]
    gelu = vit.Block(1152, 18, 4.0, dtype=torch.bfloat16, layerscale=True, ffn="mlp")
    with torch.no_grad():
        y, _ = gelu(x)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    assert routes == ["attention_block_branch_flash", "swiglu_rows",
                      "attention_block_branch_flash", "mlp_rows"]


def test_layerscale_fold_matches_the_scaled_branch():
    """The kernel route folds LayerScale into proj / w3 and their biases in
    f32: a bf16 block (plain kernel versions) within bf16 rounding (0.01 of
    a token's norm) of the f32 composition that scales the branches, and
    the same block with its scales at 1 over ten times as far off."""
    torch.manual_seed(5)
    block = vit.Block(64, 2, 4.0, dtype=torch.bfloat16, layerscale=True, ffn="swiglu")
    with torch.no_grad():
        for ls in (block.ls1, block.ls2):
            ls.gamma.uniform_(0.05, 0.5)
    x = torch.randn(2, 30, 64)
    with torch.no_grad():
        got, _ = block(x.bfloat16())
        f32 = vit.Block(64, 2, 4.0, layerscale=True, ffn="swiglu")
        f32.load_state_dict(block.state_dict())
        want, _ = f32(x)
        for ls in (block.ls1, block.ls2):
            ls.gamma.fill_(1.0)
        dropped, _ = block(x.bfloat16())
    assert _gap(got.float(), want) < 0.01
    assert _gap(dropped.float(), want) > 10 * _gap(got.float(), want)


def test_plans_of_the_new_products():
    """At a request's 25 x 1,029 rows the SwiGLU product (2 Hd columns) is
    wide, one item for each of its 22 units of 384 columns (the last of one
    128-row W tile), as are w3 and proj; the streamed qkv after the
    LayerNorm pass has the bias epilogue and goes by turns, in slices by
    waves among those whose wave of blocks spans row blocks of A that fit
    the share of L2 (a block of one tile would leave a warpgroup idle)."""
    rows = 25 * 1029
    p = fb.gemm_plan(rows, 8192, 1536, False, 132, fb.EPI_SWIGLU)
    assert (p.unit_cols, p.n_units) == (fb.GEMM_WIDE_COLS, 22)
    assert p.n_slices == p.n_units and p.items == 201 * 22
    qkv = fb.gemm_plan(rows, 4608, 1536, False, 132, fb.EPI_BIAS)
    assert qkv.unit_cols == fb.GEMM_TILE_COLS and qkv.n_units == 4608 // 128
    assert qkv.n_slices == 3
    assert (-(-132 // qkv.n_slices) + 1) * 128 * 1536 * 2 <= fb.GEMM_L2_SHARE
    for N in (8192, 4608):
        # a residual product by turns that overflows the share keeps a slice a tile
        assert fb.gemm_plan(rows, N, 768, False, 132).n_slices == N // 128
    for N, K in ((1536, 4096), (1536, 1536)):
        assert fb.gemm_plan(rows, N, K, False, 132).unit_cols == fb.GEMM_WIDE_COLS
    with pytest.raises(ValueError, match="D <= 8192"):
        fb._check_ln_width("ln_dense_rows", 8256)


# ------------------------------------------------------------------ the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_two_published_blocks_through_the_graphed_program(dev, tmp_path, monkeypatch):
    """Two blocks at the published widths (D 1,536, 24 heads of 64, hidden
    4,096, 4 registers) at 448 (1,029 tokens) exported, loaded and replayed
    as one CUDA graph, against the f32 reference on the same frames: every
    product in the port's kernels (a launch of each new entry a block a
    call). Bound: bf16 rounding over two blocks (0.03 of a token's norm).
    The eager bf16 model's registers are held to the reference's at the
    same bound: at 1,029 tokens the features barely move without them, so
    only this check sees a program that drops them."""
    from timetuning_tpu_torch.cli.export import export_features, load_exported

    monkeypatch.setattr(registry, "dinov2_giant_reg",
                        lambda dtype=torch.float32: dataclasses.replace(
                            vit.dinov2_giant_reg(dtype=dtype), depth=2))
    shape = dataclasses.replace(ref.DinoV2Shape(), depth=2)
    weights = ref.seeded_weights(shape, 3_000_000_017, dev)
    pth = tmp_path / "g14.pth"
    torch.save({k: v.cpu() for k, v in weights.items()}, pth)
    blob, live, _, _ = export_features("dinov2-g14-reg", str(pth), batch_size=3,
                                       input_resolution=448, device="cuda")
    del live
    (tmp_path / "g14.pt2").write_bytes(blob)
    serve = load_exported(str(tmp_path / "g14.pt2"), graphed=True)
    frames = torch.randint(0, 256, (3, 448, 448, 3), dtype=torch.uint8, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    for _ in range(2):
        serve(frames)                # eager, then the capture
    kernel_lib.reset_launch_counts()
    got = serve(frames)
    counts = kernel_lib.launch_counts()
    assert counts["ln_wide_dense"] == counts["swiglu_mlp"] == counts["dense_residual"] == 2
    assert counts["flash_attention"] == 2 and counts["attention_block"] == 0
    want = ref.features_u8(weights, frames, shape, 448, MEAN, STD)
    assert got.shape == want.shape == (3, 1024, 1536)
    assert _gap(got, want) < 0.03
    # the registers, which the served features do not show at 1,029 tokens:
    # the eager bf16 model's final-norm registers against the reference's
    # tokens 1 .. R
    bb = registry.get_backbone("dinov2-g14-reg", str(pth), dtype=torch.bfloat16, device="cuda")
    x = preprocess(frames, 448, MEAN, STD)
    with torch.no_grad():
        regs = bb.module(x)["registers"]
        want_regs = ref.tokens(weights, x, shape)[:, 1:1 + shape.registers]
    assert regs.shape == want_regs.shape == (3, 4, 1536)
    assert _gap(regs.float(), want_regs) < 0.03
