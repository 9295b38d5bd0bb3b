"""The pieces of the propagation kernel's design (ops/propagation_cuda.py) on
the CPU: the plain mirror of its two phases (compact rows with their count
and overflow flag, then the seg step over them) against the JAX package's
XLA path and its Pallas kernel in interpret mode, on the same numpy-seeded
inputs, tie-heavy ones included; and the tile plan's key boxes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetuning_tpu.ops import propagation as jprop
from timetuning_tpu.ops.propagation_pallas import propagate_labels_batch_pallas
from timetuning_tpu_torch.ops import propagation_cuda as prc

torch.set_num_threads(2)


def _inputs(B=2, T=4, N=16, D=24, K=6, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T, N, D)).astype(np.float32)
    logits = rng.standard_normal((B, K, N)).astype(np.float32)
    seg = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    return feats, seg.astype(np.float32)


def _mirror(feats, seg, **kw):
    """Both phases of the mirror; also the compact rows' counts."""
    f = torch.from_numpy(feats)
    keys, weights, counts = prc.compact_rows_plain(f, **kw)
    out = prc.seg_from_compact_plain(keys, weights, counts, f, torch.from_numpy(seg), **kw)
    return out.numpy(), counts


def _jax(feats, seg, **kw):
    return np.asarray(jprop.propagate_labels_batch(jnp.asarray(feats), jnp.asarray(seg), **kw))


CASES = [(7, 1, 5), (1, 2, 3), (2, 0, 5)]


@pytest.mark.parametrize("n_last,radius,topk", CASES)
def test_mirror_matches_jax_xla(n_last, radius, topk):
    feats, seg = _inputs()
    kw = dict(n_last=n_last, radius=radius, topk=topk)
    got, counts = _mirror(feats, seg, **kw)
    np.testing.assert_allclose(got, _jax(feats, seg, **kw), rtol=1e-5, atol=1e-6)
    # normal features: no ties, a row keeps k entries or its whole window
    assert bool((counts > 0).all()) and bool((counts <= topk).all())


@pytest.mark.parametrize("n_last,radius,topk", CASES)
def test_mirror_matches_pallas_kernel_interpret(n_last, radius, topk):
    feats, seg = _inputs(seed=1)
    want = propagate_labels_batch_pallas(
        jnp.asarray(feats), jnp.asarray(seg), n_last=n_last, radius=radius,
        topk=topk, interpret=True)
    got, _ = _mirror(feats, seg, n_last=n_last, radius=radius, topk=topk)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


def _twins(feats):
    feats[:, :, 8:] = feats[:, :, :8]            # every key has a twin
    feats[:, 3] = feats[:, 1]                    # and a frame repeats
    return feats


def _constant(feats):
    feats[:] = 1.0                               # every window ties whole
    return feats


def _lattice(feats):
    # entries of +-1 at 4 of 24 places: dot products in {-4..4} / 4, tied often
    rng = np.random.default_rng(7)
    lat = np.zeros_like(feats)
    cols = np.argsort(rng.random(feats.shape), axis=-1)[..., :4]
    np.put_along_axis(lat, cols, rng.choice([-1.0, 1.0], cols.shape), axis=-1)
    return lat.astype(np.float32)


@pytest.mark.parametrize("make,kw,min_overflow", [
    (_twins, dict(n_last=3, radius=0, topk=3), 0),
    (_constant, dict(n_last=3, radius=0, topk=5), 1),
    (_constant, dict(n_last=2, radius=1, topk=5), 1),
    (_lattice, dict(n_last=2, radius=1, topk=4), 0),
    (lambda f: f, dict(n_last=2, radius=2, topk=40), 1),     # k beyond the row
])
def test_mirror_is_exact_on_tie_heavy_inputs(make, kw, min_overflow):
    """Exact ties at the k-th value keep every tied entry; a row whose kept
    set does not fit ROOM entries (a constant clip, whose windows tie whole)
    or whose k exceeds LIST goes through the exact dense pass, and the result
    is the JAX package's all the same."""
    feats, seg = _inputs(B=1, T=5, N=16, D=24, K=3, seed=5)
    feats = make(feats)
    got, counts = _mirror(feats, seg, **kw)
    np.testing.assert_allclose(got, _jax(feats, seg, **kw), rtol=1e-5, atol=1e-6)
    assert int((counts < 0).sum()) >= min_overflow
    if kw["topk"] > prc.LIST:
        assert bool((counts < 0).all())


def test_compact_rows_hold_the_kept_set():
    """Ties make rows keep more than k entries; the weights of a row sum to 1
    and sit on the row's largest affinities."""
    feats, seg = _inputs(B=1, T=4, N=16, D=24, K=3, seed=9)
    feats = _twins(feats)
    keys, weights, counts = prc.compact_rows_plain(
        torch.from_numpy(feats), n_last=2, radius=0, topk=3)
    assert bool((counts >= 3).all()) and bool((counts > 3).any())
    live = counts >= 0
    assert bool((keys[live] >= 0).sum(-1).eq(counts[live]).all())
    torch.testing.assert_close(weights[live].sum(-1), torch.ones(int(live.sum())),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("h,w,radius", [
    (56, 56, 12), (14, 14, 12), (14, 14, 6), (7, 7, 1), (4, 8, 1), (56, 56, 0),
    (33, 33, 5), (3, 5, 2), (20, 9, 3),
])
def test_every_window_lies_in_its_tiles_box(h, w, radius):
    """Each query's (2r+1)^2 window, clipped to the grid, lies in the key box
    of its 8x8 tile; the box lies on the grid; the chunks cover the box with
    at most KEYS keys each."""
    plan = prc.tile_plan(h, w, radius)
    r = radius if radius > 0 else max(h, w)
    assert plan.chunk_rows * plan.box_w <= prc.KEYS
    assert plan.chunks * plan.chunk_rows >= plan.box_h > (plan.chunks - 1) * plan.chunk_rows
    for ty in range(plan.tiles_y):
        for tx in range(plan.tiles_x):
            y0, x0 = prc.tile_box(plan, h, w, radius, ty, tx)
            assert 0 <= y0 and y0 + plan.box_h <= h and 0 <= x0 and x0 + plan.box_w <= w
            for qy in range(ty * 8, min(ty * 8 + 8, h)):
                for qx in range(tx * 8, min(tx * 8 + 8, w)):
                    assert y0 <= max(qy - r, 0) and min(qy + r, h - 1) < y0 + plan.box_h
                    assert x0 <= max(qx - r, 0) and min(qx + r, w - 1) < x0 + plan.box_w


def test_tile_plan_at_the_main_paths_shapes():
    """ViT-S/8 at 448 (56x56 patches, radius 12): 49 tiles, each a 32x32 box
    of 1,024 keys in 8 chunks of 4 rows; ViT-S/16 at 224 (14x14, radius 12)
    and the train step (14x14, radius 6): 4 tiles, the whole frame of 196
    keys in two chunks of 9 and 5 rows."""
    assert prc.tile_plan(56, 56, 12) == prc.TilePlan(7, 7, 32, 32, 4, 8)
    assert prc.tile_plan(14, 14, 12) == prc.TilePlan(2, 2, 14, 14, 9, 2)
    assert prc.tile_plan(14, 14, 6) == prc.TilePlan(2, 2, 14, 14, 9, 2)
    # no neighbourhood restriction at 56x56: the whole frame, 2 rows a chunk
    assert prc.tile_plan(56, 56, 0) == prc.TilePlan(7, 7, 56, 56, 2, 28)


def test_tf32_split_rounds_to_nearest_and_recovers_the_value():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(10_000).astype(np.float32))
    hi = prc._tf32(x)
    lo = prc._tf32(x - hi)
    bits = hi.view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all()) and bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((x - hi).abs() <= x.abs() * 2.0 ** -11).all())
    # hi + lo holds x to about 2^-22 of its size: what 3xTF32 multiplies
    assert bool(((x - hi - lo).abs() <= x.abs() * 2.0 ** -21).all())


def test_dense_plan_at_the_main_paths_shapes():
    """The dense pass's blocks, row length and where a row lives: each live
    frame's window (ViT-S/8 at 448, radius 12, 4 recent frames: 5 x 625, in
    shared memory) or its whole frame (no neighbourhood, 7 recent frames:
    8 x 3,136, past a block's shared memory, in device memory); never more
    blocks than rows."""
    assert prc.dense_plan(2, 25, 56, 56, 384, 12, 4) == (prc.DENSE_BLOCKS, 5 * 625, True)
    assert prc.dense_plan(1, 25, 56, 56, 384, 0, 7) == (prc.DENSE_BLOCKS, 8 * 3136, False)
    assert prc.dense_plan(2, 25, 14, 14, 384, 12, 4) == (prc.DENSE_BLOCKS, 5 * 196, True)
    assert prc.dense_plan(1, 2, 6, 6, 64, 2, 1) == (36, 25, True)


@pytest.mark.parametrize("h,w,radius", [(2, 130, 0), (3, 140, 61)])
def test_mirror_sends_every_row_of_a_box_wider_than_a_chunk_dense(h, w, radius):
    """A key box wider than KEYS patches has no chunk plan: every row goes
    through the exact dense pass, and the result is the JAX package's."""
    assert prc.tile_plan(h, w, radius).chunk_rows == 0
    feats, seg = _inputs(B=1, T=3, N=h * w, D=8, K=3, seed=11)
    kw = dict(n_last=2, radius=radius, topk=5, spatial_size=(h, w))
    got, counts = _mirror(feats, seg, **kw)
    assert bool((counts < 0).all())
    np.testing.assert_allclose(got, _jax(feats, seg, **kw), rtol=1e-5, atol=1e-6)


def test_stats_on_the_host_are_the_plain_version_and_the_mirrors_count():
    """``propagate_labels_batch_stats`` on CPU tensors: the plain output and,
    for each target frame, the rows the mirror flags for the dense pass."""
    feats, seg = _inputs(B=2, T=5, N=16, D=24, K=3, seed=5)
    f = torch.from_numpy(_constant(feats))
    s = torch.from_numpy(seg)
    kw = dict(n_last=3, radius=1, topk=5)
    out, overflow, scratch = prc.propagate_labels_batch_stats(f, s, **kw)
    counts = prc.compact_rows_plain(f, **kw)[2]
    torch.testing.assert_close(out, prc.propagate_labels_batch_plain(f, s, **kw))
    assert overflow.tolist() == (counts < 0).sum((0, 2)).tolist()
    assert int(overflow.sum()) > 0 and scratch == 0
