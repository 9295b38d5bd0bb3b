"""SAM ViT-H's image encoder in the port (``sam-vit-h``, models/sam.py)
against the plain reference ``benchmark/reference/sam.py`` on seeded
weights, at test widths on the CPU: D 160, 2 heads of 80, 4 blocks, global
blocks 1 and 3, windows of 3, an input of 112 (a 7 x 7 grid, padded to 9 x
9 in the windowed blocks, so the crop and the zero-after-norm padding are
both exercised, and tables of 5 and 13 rows), the neck at its published 256
channels. The features through ``get_backbone`` on a release-layout file
and through a ``cli/export`` round trip, the window order and its padding,
the bias's indexing against a loop over the grid, the counts of the new
entries, the refusals. The card tests hold the new kernels (the heads-of-80
core with the bias, LN1 + qkv into window order, the GELU MLP at D 1,280)
to their plain versions at the cell's shapes, and a windowed and a global
block at the published widths through the graphed serving program to the
reference. This file imports no JAX."""

import dataclasses
import io

import pytest
import torch

from benchmark.reference import sam as ref
from timetuning_tpu_torch.models import registry
from timetuning_tpu_torch.models import sam
from timetuning_tpu_torch.ops import flash_attention as fa
from timetuning_tpu_torch.ops import fused_block as fb
from timetuning_tpu_torch.ops import kernel_lib

torch.set_num_threads(2)

TINY = ref.SamShape(patch=16, dim=160, depth=4, heads=2, hidden=640, window=3,
                    global_blocks=(1, 3), img_size=112, out_chans=256)
MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
PUBLISHED = sam.sam_vit_h


def tiny_config(**kw):
    """``sam.sam_vit_h`` cut to TINY's widths, depth, windows and input."""
    return dataclasses.replace(PUBLISHED(**kw), embed_dim=TINY.dim, depth=TINY.depth,
                               num_heads=TINY.heads, img_size=TINY.img_size,
                               window_size=TINY.window, global_blocks=TINY.global_blocks)


@pytest.fixture
def tiny_registry(monkeypatch):
    monkeypatch.setattr(sam, "sam_vit_h", tiny_config)


@pytest.fixture(scope="module")
def weights():
    return ref.seeded_weights(TINY, 3_100_000_027, "cpu")


@pytest.fixture
def release_pth(tmp_path, weights):
    """The weights in the release checkpoint's layout, with a prompt
    encoder's and a mask decoder's keys beside them."""
    path = tmp_path / "sam_vit_h.pth"
    torch.save({**weights, "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix":
                torch.randn(2, 128), "mask_decoder.iou_token.weight": torch.randn(1, 256)}, path)
    return str(path)


def _gap(got, want):
    d = torch.linalg.vector_norm(got.double() - want.double(), dim=-1)
    return float((d / torch.linalg.vector_norm(want.double(), dim=-1)).max())


def _images(n=2, seed=0):
    return torch.randn(n, TINY.img_size, TINY.img_size, 3,
                       generator=torch.Generator().manual_seed(seed))


def _qkv(N, K, D, seed, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(N, K * K, 3 * D, generator=g, device=device).bfloat16()


def _tables(K, seed, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple((ref.REL_POS_STD * torch.randn(2 * K - 1, 80, generator=g,
                                                device=device)).bfloat16() for _ in range(2))


def test_published_configuration_and_layout():
    c = sam.sam_vit_h()
    assert (c.patch_size, c.embed_dim, c.depth, c.num_heads, c.mlp_ratio) == (16, 1280, 32, 16, 4.0)
    assert (c.img_size, c.grid, c.window_size, c.global_blocks, c.out_chans) == (
        1024, 64, 14, (7, 15, 23, 31), 256)
    with torch.device("meta"):
        m = sam.SamImageEncoder(c)
    want = {k[len(ref.PREFIX):]: v for k, v in ref.param_shapes(ref.SamShape()).items()}
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == want
    assert m.blocks[7].attn.rel_pos_h.shape == (127, 80)
    assert m.blocks[6].attn.rel_pos_w.shape == (27, 80)
    assert m.blocks[0].mlp.lin1.out_features == 5120 and m.blocks[0].norm1.eps == 1e-6
    assert "sam-vit-h" in registry.ALL_ARCHITECTURES
    assert "sam-vit-h" not in registry.ARCHITECTURES + registry.VIT_NAMES


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5), (torch.bfloat16, 0.03)])
def test_features_through_get_backbone_match_the_reference(tiny_registry, release_pth,
                                                           weights, dtype, bound):
    """The release-layout ``.pth`` (the prompt encoder's and mask decoder's
    keys in it) through ``get_backbone``: f32 (the plain composition) within
    f32 summation order of the reference; bf16 (the kernels' plain versions
    on the CPU: LN1 + qkv into window order, the heads-of-80 core with the
    bias, proj + residual, the GELU MLP) within bf16 rounding over four
    blocks and the neck (0.03 of a token's norm, as the other ViTs')."""
    bb = registry.get_backbone("sam-vit-h", release_pth, dtype=dtype, device="cpu")
    assert (bb.patch_size, bb.feature_dim, bb.drop_cls, bb.norm_std) == (
        16, 256, False, tuple(STD))
    x = _images()
    with torch.no_grad():
        out = bb.module(x)
        feats, probs = bb.apply(x)
        want = ref.features(weights, x, TINY)
    assert out["grid"] == (7, 7) and probs is None
    assert feats.shape == want.shape == (2, 49, 256) and feats.dtype == dtype
    assert _gap(feats, want) < bound


def test_export_round_trip_matches_the_reference(tiny_registry, release_pth, weights):
    """``cli/export`` of the bf16 program (the new entries custom ops in
    it) and ``load_exported`` on the CPU, against the reference's features
    of the same uint8 frames through SAM's normalisation (std 0.229); bound:
    bf16 rounding."""
    from timetuning_tpu_torch.cli.export import export_features, load_exported

    blob, live, shape, _ = export_features("sam-vit-h", release_pth, batch_size=2,
                                           input_resolution=112, device="cpu")
    program = torch.export.load(io.BytesIO(blob))
    ops = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {"timetuning_tpu_torch.ln_window_dense_rows.default",
            "timetuning_tpu_torch.ln_dense_rows.default",
            "timetuning_tpu_torch.relpos_attention.default",
            "timetuning_tpu_torch.dense_residual_rows.default",
            "timetuning_tpu_torch.mlp_rows.default"} <= ops
    serve = load_exported(io.BytesIO(blob))
    frames = torch.randint(0, 256, (2, 112, 112, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = serve(frames)
        want = ref.features_u8(weights, frames, TINY, MEAN, STD)
        torch.testing.assert_close(got, live(frames), rtol=0, atol=0)
    assert got.shape == want.shape == (2, 49, 256)
    assert _gap(got, want) < 0.03


def test_window_order_pads_after_the_norm_and_crops():
    """``window_rows`` cuts the 7 x 7 grid padded to 9 x 9 into nine
    windows of 3 x 3 (frame by frame, window by window, raster order in
    each), the padding zero rows; ``grid_rows`` is its inverse with the crop.
    LN1 + qkv in window order: a padded row's output is exactly the bias
    (its normed row is zeros, as SAM pads LN1's output), a real row's is
    ``ln_dense_xla``'s of its grid row."""
    g = torch.Generator().manual_seed(3)
    B, G, win, D = 2, 7, 3, 64
    x = torch.randn(B, G * G, D, generator=g)
    w = fa.window_rows(x, G, win)
    assert w.shape == (B * 9, 9, D)
    # window (1, 2) of frame 1, its row (2, 0): grid row (5, 6)
    torch.testing.assert_close(w[9 + 1 * 3 + 2, 2 * 3 + 0], x[1, 5 * G + 6])
    assert w[2, 1 * 3 + 1].abs().sum() == 0           # grid (1, 7): past the grid
    torch.testing.assert_close(fa.grid_rows(w, G, win), x)
    xb = x.bfloat16()
    ln = (1 + 0.1 * torch.randn(D, generator=g), 0.1 * torch.randn(D, generator=g))
    wq, bq = torch.randn(D, 3 * D, generator=g) / 8, torch.randn(3 * D, generator=g)
    got = fb.ln_window_dense_rows(xb, *ln, wq, bq, G, win)
    pad = fa.window_rows(torch.ones(B, G * G, 1), G, win)[..., 0] == 0
    assert int(pad.sum()) == B * (81 - 49)
    assert torch.equal(got[pad], bq.bfloat16().expand(int(pad.sum()), -1))
    plain = fb.ln_dense_xla(xb, *ln, wq, bq)
    torch.testing.assert_close(fa.grid_rows(got, G, win), plain, rtol=0, atol=0)


@pytest.mark.parametrize("K,window", [(3, 3), (7, 0)])
def test_relpos_core_bias_against_a_loop_over_the_grid(K, window):
    """The core's plain version at both table sizes (a window's 5 rows, the
    7 x 7 grid's 13): its scores' bias against ``q . Rh[qh - kh + K - 1] + q
    . Rw[qw - kw + K - 1]`` written out by coordinates, and the softmax of
    ``(q scale) k^T + bias`` over v, merged and cropped."""
    G, H, D = 7, 2, 160
    N = 2 * (9 if window else 1)
    qkv = _qkv(N, K, D, seed=K)
    rh, rw = _tables(K, seed=10 + K)
    got = fa.relpos_attention(qkv, rh, rw, H, G, window)
    t = qkv.float().reshape(N, K * K, 3, H, 80)
    q, k, v = (t[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    bias = torch.empty(N, H, K * K, K * K)
    for r in range(K * K):
        for c in range(K * K):
            (qh, qw), (kh, kw) = divmod(r, K), divmod(c, K)
            bias[:, :, r, c] = ((q[:, :, r] * rh.float()[qh - kh + K - 1]).sum(-1)
                                + (q[:, :, r] * rw.float()[qw - kw + K - 1]).sum(-1))
    p = torch.softmax(q @ k.transpose(-2, -1) * 80 ** -0.5 + bias, dim=-1)
    o = (p.bfloat16().float() @ v).permute(0, 2, 1, 3).reshape(N, K * K, D)
    want = fa.grid_rows(o, G, window) if window else o
    assert got.shape == (2, G * G, D) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, atol=4e-3, rtol=1e-2)
    no_bias = fa.relpos_attention(qkv, 0 * rh, 0 * rw, H, G, window)
    assert (no_bias.float() - got.float()).abs().max() > 0.05


def test_the_encoder_takes_only_its_input_size(weights):
    m = sam.SamImageEncoder(tiny_config())
    with pytest.raises(ValueError, match="never resizes"):
        m(torch.zeros(1, 128, 128, 3))
    with pytest.raises(ValueError, match="attention"):
        m(torch.zeros(1, 112, 112, 3), want_attention=True)


def test_parallel_forwards_refuse_sam():
    from timetuning_tpu_torch.parallel import pp, sp

    m = sam.SamImageEncoder(tiny_config())

    class Mesh:
        coords, n_inner, n_outer, inner, inner_index = (0, 0), 2, 1, None, 0

    for fn in (sp.sp_forward_fn, pp.pp_forward_fn):
        with pytest.raises(ValueError, match="SamImageEncoder runs on one device"):
            fn(m, Mesh()) if fn is sp.sp_forward_fn else fn(m, Mesh(), 1)


def test_launch_and_work_counts_of_the_new_entries(monkeypatch):
    """At the cell's shapes, on meta tensors with the launch stood in for:
    a windowed block's LN1 + qkv counts ``ln_window_dense`` and the padded
    rows it computes (8 x (4,900 - 4,096)); its core ``flash_relpos`` and
    8 x 25 x 16 window sequences, all in the resident form, a global block's
    8 x 16 grid sequences, none in it; the GELU MLP at D 1,280
    ``mlp_wide``."""
    launched = []
    monkeypatch.setattr(kernel_lib, "require_cuda", lambda *a: None)
    monkeypatch.setattr(kernel_lib, "launch", lambda kernel, fn, *a: launched.append(kernel))
    monkeypatch.setattr(kernel_lib, "sm_count", lambda device: 132)
    kernel_lib.reset_launch_counts()
    meta = dict(device="meta", dtype=torch.bfloat16)
    x = torch.zeros(8, 4096, 1280, **meta)
    ln = (torch.zeros(1280, device="meta"), torch.zeros(1280, device="meta"))
    w = torch.zeros(1280, 3840, **meta)
    qkv = fb.ln_window_dense_rows(x, *ln, w, None, 64, 14)
    assert qkv.shape == (200, 196, 3840)
    rh = torch.zeros(27, 80, **meta)
    assert fa.relpos_attention(qkv, rh, rh, 16, 64, 14).shape == (8, 4096, 1280)
    rg = torch.zeros(127, 80, **meta)
    fa.relpos_attention(torch.zeros(8, 4096, 3840, **meta), rg, rg, 16, 64, 0)
    fb.mlp_rows(x, *ln, torch.zeros(1280, 5120, **meta), None, torch.zeros(5120, 1280, **meta),
                None)
    assert launched == ["ln_window_dense", "flash_relpos", "flash_relpos", "mlp_wide"]
    assert {k: kernel_lib.WORK_COUNTS[k] for k in ("relpos_windows", "relpos_global",
                                                   "relpos_windows_resident",
                                                   "window_pad_rows")} == {
        "relpos_windows": 200 * 16, "relpos_global": 8 * 16,
        "relpos_windows_resident": 200 * 16, "window_pad_rows": 8 * 804}
    with pytest.raises(ValueError, match="heads of 80"):
        fa.relpos_attention(qkv, rh, rh, 20, 64, 14)
    kernel_lib.reset_launch_counts()


@pytest.mark.parametrize("G,window", [(64, 17), (64, 32), (32, 0), (63, 0)])
def test_the_core_refuses_a_side_it_has_no_form_for(monkeypatch, G, window):
    """The card's core has a form for sequences of side K <= 16 (windows)
    and for K = 64 (SAM's grid) alone: any other side is refused before a
    launch, windowed or global."""
    launched = []
    monkeypatch.setattr(kernel_lib, "require_cuda", lambda *a: None)
    monkeypatch.setattr(kernel_lib, "launch", lambda kernel, fn, *a: launched.append(kernel))
    K = window or G
    nw = -(-G // window) if window else 1
    meta = dict(device="meta", dtype=torch.bfloat16)
    rk = torch.zeros(2 * K - 1, 80, **meta)
    with pytest.raises(ValueError, match=f"K = 64; got K = {K} "):
        fa.relpos_attention(torch.zeros(nw * nw, K * K, 3 * 160, **meta), rk, rk, 2, G, window)
    assert launched == []


# ------------------------------------------------------------------ the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _exact(qkv, rh, rw, H, G, window):
    """The core's result in f64 with p unrounded, and sum_k p_k |v_k|, both
    in the grid's rows (merged and cropped as the core's)."""
    N, S, E = qkv.shape
    K = window or G
    t = qkv.double().reshape(N, S, 3, H, 80)
    q, k, v = (t[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    idx = fa.rel_index(K, qkv.device)
    rq = q.reshape(N, H, K, K, 80)
    bh = torch.einsum("nhyxc,ykc->nhyxk", rq, rh.double()[idx])
    bw = torch.einsum("nhyxc,xkc->nhyxk", rq, rw.double()[idx])
    s = (q @ k.transpose(-1, -2) * 80 ** -0.5).view(N, H, K, K, K, K)
    p = torch.softmax((s + bh[..., :, None] + bw[..., None, :]).view(N, H, S, S), -1)
    out = ((p @ x).permute(0, 2, 1, 3).reshape(N, S, E // 3) for x in (v, v.abs()))
    return [fa.grid_rows(o, G, window) if window else o for o in out]


@pytest.mark.cuda
@pytest.mark.parametrize("G,window", [(64, 14), (9, 4), (32, 16), (64, 0)])
def test_relpos_core_matches_plain(dev, G, window):
    """The heads-of-80 core with the bias, counted as ``flash_relpos``, 8
    frames x 16 heads: a windowed block at the cell's shapes (25 windows of
    196 tokens a frame, K 14, the crop in its stores), a ragged grid (windows
    of 4 over 9 x 9, padded to 12 x 12), windows of 256 tokens (K 16, the
    largest the resident form takes) and a global block's 4,096 tokens (K 64),
    two frames at a time. The windows take the resident form
    (``relpos_windows_resident`` counts their pairs), the grid the streamed
    one. Bounds: against ``relpos_attention_xla``, the other flash forms'
    (one bf16 ulp of the output plus p's rounding) where a row has 196 keys
    or more; every windowed case also within the rounding of p and of the
    output of the exact (f64) result, |o - o_exact| <= 2^-8 (sum_k p_k |v_k|
    + |o_exact|) + 1e-4 (bf16's unit roundoff 2^-8; p rounded before p v,
    the output once). At 16 keys a row p's rounding alone moves the plain
    version up to 0.013 from the exact result, past the first bound, so
    those windows are held to the second. An f32 input raises."""
    H, D = 16, 1280
    K = window or G
    nw = -(-G // window) if window else 1
    N = 8 * nw * nw
    qkv = _qkv(N, K, D, seed=K, device=dev)
    rh, rw = _tables(K, seed=K + 1, device=dev)
    kernel_lib.reset_launch_counts()
    got = fa.relpos_attention(qkv, rh, rw, H, G, window)
    assert kernel_lib.launch_counts()["flash_relpos"] == 1
    assert kernel_lib.WORK_COUNTS["relpos_windows_resident"] == (N * H if window else 0)
    per = N // 8 * 2
    for i in range(0, N, per):
        f = i // (N // 8)
        if K * K >= 196:
            want = fa.relpos_attention_xla(qkv[i:i + per], rh, rw, H, G, window)
            torch.testing.assert_close(got[f:f + 2].float(), want.float(), atol=4e-3,
                                       rtol=1e-2)
        if window:
            exact, spread = _exact(qkv[i:i + per], rh, rw, H, G, window)
            err = (got[f:f + 2].double() - exact).abs()
            assert bool((err <= 2 ** -8 * (spread + exact.abs()) + 1e-4).all()), float(err.max())
    with pytest.raises(ValueError, match="bf16"):
        fa.relpos_attention(qkv.float(), rh, rw, H, G, window)


@pytest.mark.cuda
def test_an_f32_encoder_on_the_card_raises(dev):
    """The card's core at heads of 80 is bf16 only: an f32 encoder's first
    block raises there instead of running the plain composition on the card,
    and no kernel is launched."""
    m = sam.SamImageEncoder(tiny_config(dtype=torch.float32)).to(dev)
    kernel_lib.reset_launch_counts()
    with pytest.raises(ValueError, match="bf16 only"):
        m(torch.zeros(1, TINY.img_size, TINY.img_size, 3, device=dev))
    assert not any(kernel_lib.launch_counts().values())


@pytest.mark.cuda
def test_ln_window_dense_matches_plain(dev):
    """LN1 + qkv into window order at the cell's 8 x 4,096 rows of D 1,280
    (8 x 4,900 window rows), counted as ``ln_window_dense``, against its
    plain version; the padded rows are the bias exactly. Bound: bf16
    rounding at O(1) values, as the other tiles'."""
    g = torch.Generator(device=dev).manual_seed(4)
    D = 1280
    x = torch.randn(8, 4096, D, device=dev, generator=g).bfloat16()
    ln = (1 + 0.1 * torch.randn(D, device=dev, generator=g),
          0.1 * torch.randn(D, device=dev, generator=g))
    w = (torch.randn(3 * D, D, device=dev, generator=g) / 36).t().bfloat16()
    b = 0.1 * torch.randn(3 * D, device=dev, generator=g)
    kernel_lib.reset_launch_counts()
    got = fb.ln_window_dense_rows(x, *ln, w, b, 64, 14)
    assert kernel_lib.launch_counts()["ln_window_dense"] == 1
    want = fb.ln_window_dense_xla(x, *ln, w, b, 64, 14)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)
    pad = fa.window_rows(torch.ones(8, 4096, 1, device=dev), 64, 14)[..., 0] == 0
    assert torch.equal(got[pad], b.bfloat16().expand(int(pad.sum()), -1))


@pytest.mark.cuda
def test_gelu_mlp_at_1280_matches_plain(dev):
    """The GELU MLP at the cell's 8 x 4,096 rows, D 1,280 -> 5,120 -> 1,280
    (the LayerNorm pass, the tile's bias-GELU epilogue without the prologue,
    fc2 + residual wide), counted as ``mlp_wide``, against
    ``mlp_block_xla``. Bound: bf16 rounding, as the other MLP kernels'."""
    g = torch.Generator(device=dev).manual_seed(5)
    D, Hd = 1280, 5120
    x = torch.randn(8, 4096, D, device=dev, generator=g).bfloat16()
    ln = (1 + 0.1 * torch.randn(D, device=dev, generator=g),
          0.1 * torch.randn(D, device=dev, generator=g))
    w1 = (torch.randn(Hd, D, device=dev, generator=g) / 36).t().bfloat16()
    b1 = 0.1 * torch.randn(Hd, device=dev, generator=g)
    w2 = (torch.randn(D, Hd, device=dev, generator=g) / 72).t().bfloat16()
    b2 = 0.1 * torch.randn(D, device=dev, generator=g)
    kernel_lib.reset_launch_counts()
    got = fb.mlp_rows(x, *ln, w1, b1, w2, b2)
    assert kernel_lib.launch_counts()["mlp_wide"] == 1
    want = fb.mlp_block_xla(x, *ln, w1, b1, w2, b2)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
def test_a_windowed_and_a_global_block_through_the_graphed_program(dev, tmp_path,
                                                                 monkeypatch):
    """Two blocks at the published widths (D 1,280, 16 heads of 80, MLP
    5,120; block 0 windowed, block 1 global) and the neck at 1,024 through
    ``get_backbone``, ``export_features`` and ``load_exported(graphed=True)``,
    against the f32 reference on the same frames: every block's products,
    norms and attention core in the port's kernels (one launch of each entry
    a block a call; the windows' pairs all in the resident form, counted on
    the replay). Bound: bf16 rounding over two blocks and the neck (0.03 of
    a token's norm)."""
    from timetuning_tpu_torch.cli.export import export_features, load_exported

    monkeypatch.setattr(sam, "sam_vit_h",
                        lambda **kw: dataclasses.replace(sam.SamConfig(**kw), depth=2,
                                                         global_blocks=(1,)))
    shape = ref.SamShape(depth=2, global_blocks=(1,))
    weights = ref.seeded_weights(shape, 3_100_000_031, dev)
    pth = tmp_path / "sam.pth"
    torch.save({k: v.cpu() for k, v in weights.items()}, pth)
    blob, live, _, _ = export_features("sam-vit-h", str(pth), batch_size=2,
                                       input_resolution=1024, device="cuda")
    del live
    (tmp_path / "sam.pt2").write_bytes(blob)
    serve = load_exported(str(tmp_path / "sam.pt2"), graphed=True)
    frames = torch.randint(0, 256, (2, 1024, 1024, 3), dtype=torch.uint8, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    for _ in range(2):
        serve(frames)                # eager, then the capture
    kernel_lib.reset_launch_counts()
    got = serve(frames)
    counts = {**kernel_lib.launch_counts(), **kernel_lib.WORK_COUNTS}
    assert counts["flash_relpos"] == counts["mlp_wide"] == counts["dense_residual"] == 2
    assert counts["ln_window_dense"] == counts["ln_wide_dense"] == 1
    assert counts["flash_attention"] == counts["mlp_rows"] == 0
    assert (counts["relpos_windows"], counts["relpos_global"]) == (2 * 25 * 16, 2 * 16)
    assert counts["relpos_windows_resident"] == counts["relpos_windows"]
    want = ref.features_u8(weights, frames, shape, MEAN, STD)
    assert got.shape == want.shape == (2, 4096, 256)
    assert _gap(got, want) < 0.03
