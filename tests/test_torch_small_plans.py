"""The host plans of the eval preprocess (K4, ``ops/preprocess_cuda.band_plan``)
and of the Sinkhorn kernel (K11, ``ops/sinkhorn_cuda.sinkhorn_plan``), and the
Sinkhorn's route, on the CPU at small shapes. The kernels themselves run on
the card only (tests/test_torch_kernels_cuda.py); here their schedules are
replayed in numpy: K4's streaming of input rows through its ring and the
order in which it writes its outputs, K11's diagonal scaling with the total
mass folded into the row scaling, each against the plain version."""

import numpy as np
import pytest
import torch

from timetuning_tpu_torch.data.transforms import IMAGENET_MEAN, REFERENCE_STD
from timetuning_tpu_torch.ops import preprocess_cuda as pc
from timetuning_tpu_torch.ops import sinkhorn as skm
from timetuning_tpu_torch.ops import sinkhorn_cuda as sk

torch.set_num_threads(2)

# (h, w, s, frames): the eval's two outputs, small shapes, odd widths whose
# rows are no multiple of 16 bytes, an output size whose rows are no
# multiple of 8 values, the in-training eval's Pascal batch at scale 1
SHAPES = [(480, 854, 224, 50), (480, 854, 448, 50), (64, 64, 48, 3),
          (60, 107, 28, 3), (61, 103, 48, 2), (33, 77, 17, 2), (480, 854, 224, 1),
          (224, 224, 224, 60)]


@pytest.mark.parametrize("h,w,s,frames", SHAPES)
def test_band_plan_covers_every_output_row_once(h, w, s, frames):
    plan = pc.band_plan(h, w, s, frames)
    rows = [y for y0, y1 in plan.band_rows(s) for y in range(y0, y1)]
    assert rows == list(range(s))
    assert len(plan.band_rows(s)) == plan.bands


@pytest.mark.parametrize("h,w,s,frames", SHAPES)
def test_band_input_ranges_hold_every_nonzero_tap(h, w, s, frames):
    """Each band's input rows [start of its first row, end of its last) hold
    every nonzero weight of its rows in the dense matrix, and the band's
    input rows are at most ``in_rows``."""
    plan = pc.band_plan(h, w, s, frames)
    dense = pc._resize_weights(h, s)
    start, taps = pc._band(dense)
    assert taps.shape[1] == plan.h_taps
    for y0, y1 in plan.band_rows(s):
        r_lo, r_hi = start[y0], start[y1 - 1] + plan.h_taps
        assert r_hi - r_lo <= plan.in_rows
        nz = np.nonzero(dense[y0:y1])[1]
        assert nz.min() >= r_lo and nz.max() < r_hi


@pytest.mark.parametrize("h,w,s,frames", SHAPES)
def test_band_plan_fits_shared_memory(h, w, s, frames):
    plan = pc.band_plan(h, w, s, frames)
    assert plan.smem == pc.smem_bytes(w, s, plan.rows, plan.chunk, plan.ring,
                                      plan.h_taps, plan.w_taps)
    assert plan.smem <= 232448 and plan.blocks_per_sm >= 1
    if (h, w, frames) == (480, 854, 50):
        # several blocks an SM, and at most one wave of them on 132 SMs
        assert plan.blocks_per_sm >= 3
        assert frames * plan.bands <= 2 * 132 * plan.blocks_per_sm


def test_band_plan_layout_at_the_eval_shape():
    """480x854 -> 224 by hand: chunks of 2 rows (5,124 + 15 bytes rounded to
    5,152, four stages), a ring of 2 + 5 - 1 + 3 rows of 672 floats in rows of
    768, the W
    starts and taps (8 a pixel), the band's H starts, ring slots and taps."""
    plan = pc.band_plan(480, 854, 224, 50)
    assert (plan.chunk, plan.ring, plan.h_taps, plan.w_taps) == (2, 9, 5, 8)
    want = (4 * 5152 + 9 * 768 * 4 + 224 * 4 + 224 * 8 * 4
            + 2 * -(-plan.rows * 4 // 16) * 16 + -(-plan.rows * 5 * 4 // 16) * 16)
    assert plan.smem == want


def test_band_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        pc.band_plan(5000, 5000, 5000, 1)


def _replay_kernel(frames: np.ndarray, s: int, plan) -> tuple[np.ndarray, np.ndarray]:
    """csrc/preprocess.cu's schedule in numpy, f64: per band, chunks of input
    rows through the W pass into a ring of ``plan.ring`` slots, then the
    ready output values in 16-byte groups (the last partial group of a step
    waits for the next one unless the band ends). Fails if a value reads a
    ring slot that no longer holds its input row; returns the output and how
    many times each value was written."""
    F, h, w, _ = frames.shape
    hs, hw = pc._band(pc._resize_weights(h, s))
    ws, ww = pc._band(pc._resize_weights(w, s))
    wdense = np.zeros((s, w))
    for x in range(s):
        wdense[x, ws[x]:ws[x] + ww.shape[1]] = ww[x]
    ht = plan.h_taps
    mean, std = np.array(IMAGENET_MEAN), np.array(REFERENCE_STD)
    S3 = 3 * s
    out = np.zeros(F * s * S3)
    writes = np.zeros(F * s * S3, np.int64)
    for f in range(F):
        for y0, y1 in plan.band_rows(s):
            r_lo, r_hi = hs[y0], hs[y1 - 1] + ht
            ring = np.zeros((plan.ring, S3))
            held = np.full(plan.ring, -1)
            out0 = f * s * S3
            e_done, e_end, y_ready = out0 + y0 * S3, out0 + y1 * S3, y0
            for ra in range(r_lo, r_hi, plan.chunk):
                rb = min(r_hi, ra + plan.chunk)
                for r in range(ra, rb):
                    slot = (r - r_lo) % plan.ring
                    ring[slot] = (wdense @ frames[f, r].astype(np.float64)).reshape(-1)
                    held[slot] = r
                while y_ready < y1 and hs[y_ready] + ht <= rb:
                    y_ready += 1
                e_ready = out0 + y_ready * S3
                e_hi = e_end if y_ready == y1 else e_ready // 8 * 8
                for e in range(e_done, max(e_done, e_hi)):
                    y, v = divmod(e - out0, S3)
                    acc = 0.0
                    for k in range(ht):
                        slot = (hs[y] - r_lo + k) % plan.ring
                        assert held[slot] == hs[y] + k, (f, y0, y, k)
                        acc += hw[y, k] / 255.0 * ring[slot, v]
                    out[e] = (acc - mean[v % 3]) / std[v % 3]
                    writes[e] += 1
                e_done = max(e_done, e_hi)
    return out.reshape(F, s, s, 3), writes


@pytest.mark.parametrize("h,w,s", [(60, 107, 28), (64, 64, 48), (33, 77, 17), (40, 90, 32),
                                   (40, 40, 40)])
def test_kernel_schedule_writes_each_value_once_and_matches_plain(h, w, s):
    frames = np.random.default_rng(h * w).integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    plan = pc.band_plan(h, w, s, 2)
    got, writes = _replay_kernel(frames, s, plan)
    assert (writes == 1).all()
    want = pc.eval_preprocess_plain(torch.from_numpy(frames), s, IMAGENET_MEAN,
                                    REFERENCE_STD, out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_kernel_schedule_at_the_eval_rows():
    """The eval's rows (480 -> 224: 5 H taps, steps of up to 3 rows) in the
    bands of a 50-frame group, on one frame 300 pixels wide (7-row chunks)."""
    frames = np.random.default_rng(1).integers(0, 256, (1, 480, 300, 3), dtype=np.uint8)
    plan = pc.band_plan(480, 300, 224, 50)
    assert plan.rows > 1 and plan.ring == plan.chunk + plan.h_taps - 1 + 3
    got, writes = _replay_kernel(frames, 224, plan)
    assert (writes == 1).all()
    want = pc.eval_preprocess_plain(torch.from_numpy(frames), 224, IMAGENET_MEAN,
                                    REFERENCE_STD, out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


# ---- K11: the plan and the route ----

@pytest.mark.parametrize("B,cols,in_smem", [(6272, 53, True), (25088, 210, True),
                                            (22656, 189, True), (41472, 346, False)])
def test_sinkhorn_plan_at_the_steps_shapes(B, cols, in_smem):
    """200 prototypes against the score matrices of a 32- and a 128-clip
    step, a 32-clip step with its queue full and a 128-clip one with its
    queue (33 MB: the slabs stay in device memory), on the 15 clusters of 8
    an H100 holds with one block an SM."""
    plan = sk.sinkhorn_plan(200, B, 15)
    assert (plan.cols, plan.in_smem, plan.blocks, plan.clusters) == (cols, in_smem, 120, 15)
    assert plan.smem == sk.smem_bytes(200, cols, in_smem) <= 232448
    assert plan.blocks * plan.cols >= B > (plan.blocks - 8) * plan.cols


@pytest.mark.parametrize("K,B,clusters", [(8, 50, 16), (200, 300, 16), (200, 6272, 15),
                                          (1024, 6272, 16), (3, 100000, 16)])
def test_sinkhorn_plan_spreads_columns_over_whole_clusters(K, B, clusters):
    plan = sk.sinkhorn_plan(K, B, clusters)
    assert plan.blocks % 8 == 0 and plan.blocks <= 8 * clusters
    assert plan.cols >= 16 and plan.blocks * plan.cols >= B
    assert plan.blocks == 8 or (plan.blocks - 8) * plan.cols < B
    assert plan.smem <= 232448


def test_sinkhorn_plan_refuses_what_no_slab_takes():
    with pytest.raises(ValueError, match="K <= 1024"):
        sk.sinkhorn_plan(1025, 6272, 16)
    with pytest.raises(ValueError, match="no plan"):
        sk.sinkhorn_plan(200, 0, 16)


def test_sinkhorn_route():
    assert skm.sinkhorn_route(torch.device("cuda", 0)) == "kernel"
    assert skm.sinkhorn_route(torch.device("cuda", 0), group=object()) == "kernel_dp"
    assert skm.sinkhorn_route(torch.device("cpu"), group=object()) == "matvec"
    assert skm.sinkhorn_route(torch.device("cpu")) == "matvec"


def _scores(B, K, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, (B, K))
                            .astype(np.float32))


@pytest.mark.parametrize("world_size", [1, 2])
@pytest.mark.parametrize("with_valid", [False, True])
def test_assignment_on_the_cpu_is_the_matvec_form(with_valid, world_size):
    """On CPU tensors the step's assignment and both kernel entries give the
    matvec form, exactly as before the kernel was dispatched."""
    s = _scores(90, 12, seed=5)
    valid = (torch.from_numpy(np.random.default_rng(6).uniform(size=90)) > 0.3).float() \
        if with_valid else None
    want = skm.sinkhorn(torch.exp(s / 0.05).t(), 10, world_size=world_size, valid=valid)
    got = skm.sinkhorn_assignment(s, 0.05, 10, world_size=world_size, valid=valid)
    assert torch.equal(got, want)
    assert torch.equal(sk.sinkhorn_assignment_cuda(s, 0.05, 10, valid, world_size), want)
    assert torch.equal(sk.sinkhorn_cuda(torch.exp(s / 0.05).t(), 10, valid, world_size), want)


def _kernel_form(Q: np.ndarray, n_iters: int, valid=None, world_size: int = 1):
    """csrc/sinkhorn.cu's arithmetic in f32 numpy: Q kept unscaled, the total
    mass folded into a (a starts at 1 / (total + eps)), one sweep an
    iteration: x = Q^T a, b from x, then the next row partials from the new
    b; the last sweep writes the output from the same x."""
    f = np.float32
    eps = f(1e-12)
    Q = Q.astype(f)
    K, B = Q.shape
    if valid is not None:
        Q = Q * valid.astype(f)[None, :]
    v = Q.sum(axis=1, dtype=f)                      # the first row partials
    c = f(1.0 / (B * world_size + 1e-12)) if valid is None else \
        f(1) / (valid.astype(f).sum() + eps)
    a = np.full(K, f(1) / (v.sum(dtype=f) + eps), f)
    b = np.ones(B, f)
    r = f(1) / f(K)
    out = None
    for it in range(n_iters):
        u = a * v
        a = np.where(u > 0, a * (r / (u + eps)), f(0)).astype(f)
        x = (Q * a[:, None]).sum(axis=0, dtype=f)
        col = b * x
        b = np.where(col > 0, b * (c / (col + eps)), f(0)).astype(f)
        if it + 1 < n_iters:
            v = (Q * b[None, :]).sum(axis=1, dtype=f)
        else:
            out = (Q * a[:, None] * (b / (b * x + eps))[None, :]).T
    return out


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("K,B", [(8, 50), (200, 392)])
def test_kernel_form_of_the_arithmetic_equals_the_matvec_form(K, B, with_valid):
    """The kernel's reordering (the total folded into a, x reused for the
    output) is the matvec form within f32 rounding, zero rows and masked
    columns included."""
    rng = np.random.default_rng(K + B)
    Q = np.exp(rng.uniform(-1, 1, (K, B)) / 0.05).astype(np.float32)
    Q[1] = 0.0                                      # an underflowed prototype
    valid = (rng.uniform(size=B) > 0.3).astype(np.float32) if with_valid else None
    got = _kernel_form(Q, 10, valid)
    want = skm.sinkhorn(torch.from_numpy(Q), 10,
                        valid=None if valid is None else torch.from_numpy(valid)).numpy()
    assert np.isfinite(got).all() and (got[:, 1] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-8)
