"""The SAM cell's driver (``drivers/serve_export_sam.py``) at tiny widths on
the CPU (D 160, 2 heads of 80, 4 blocks, global blocks 1 and 3, windows of
3, f32, 112 x 112 frames: a 7 x 7 grid padded to 9 x 9 in the windowed
blocks): ``correct`` against the reference, the control and each fault
against the cell's own limit or, for the fault that reads under it at the
cell's size, against the f32 program's own gap, the
counts at the tiny and the published shapes, the new readers silent on a
trace without their kernels, the driver failing at once on a port without
the architecture, and the cell found by name."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time

import pytest
import torch
from conftest import ROOT

from benchmark import counts, counts_dinov2, counts_sam, harness
from benchmark.reference import sam as ref

CELL = "serve-samh-c8"
TINY = {"name": "tiny-samh", "architecture": "sam-vit-h", "patch_size": 16, "embed_dim": 160,
        "depth": 4, "num_heads": 2, "mlp_hidden": 640, "window_size": 3,
        "global_attn_indexes": [1, 3], "input_size": 112, "out_chans": 256,
        "dtype": "float32", "normalize_mean": [0.485, 0.456, 0.406],
        "normalize_std": [0.229, 0.224, 0.225]}
TRAFFIC = {"entry": "serve_export_sam", "frames": 2, "height": 112, "width": 112,
           "bank_clips": 2, "objects": [1, 2], "textured": True, "background": "noise",
           "warm_calls": 1, "sample_p": 1.0, "sample_keep": 2, "compare": 2}
# what the cell's limit fails at its size and here; the padding before the
# norm reads under the limit at the cell's size (PERF.md section 7) and is
# held here against the f32 program's gap
CAUGHT = ("control", "fault:no_relpos", "fault:all_global", "fault:pad_masked",
          "fault:relpos_swapped", "fault:altered")


@pytest.fixture
def tiny_port(monkeypatch):
    """The port's ``sam-vit-h`` cut to TINY's widths, depth and input."""
    from timetuning_tpu_torch.models import sam

    published = sam.sam_vit_h

    def tiny(**kw):
        return dataclasses.replace(published(**kw), embed_dim=160, depth=4, num_heads=2,
                                   img_size=112, window_size=3, global_blocks=(1, 3))
    monkeypatch.setattr(sam, "sam_vit_h", tiny)


def _run(mode=None, seed=9):
    from benchmark.run import Run

    cell = harness.Cell({"name": "tiny-samh", "chips": 1}, dict(TINY), dict(TRAFFIC), [], [])
    driver = harness.load_driver(cell)
    with tempfile.TemporaryDirectory() as work_dir:
        run = Run(cell, seed, 0.5, False, torch.device("cpu"), time.perf_counter(), work_dir)
        run.mode = mode
        return driver.run(run)


def _correct(numbers: dict) -> bool:
    limits = harness.load_json(ROOT / "benchmark" / "limits" / f"{CELL}.json")["limits"]
    return all(c["ok"] for c in harness.judge(numbers, limits).values())


def test_program_is_correct_with_its_facts(tiny_port):
    out = _run()
    assert out["correct"] and _correct(out["numbers"]), out["numbers"]
    assert out["numbers"]["token_gap"] < 1e-4
    f = out["facts"]
    assert f["requests"] == out["attempted"] > 0
    assert f["flops_per_request"] > 0 and 0 < f["attn80_least_s"] < f["blocks_least_s_samh"]
    assert 0 < f["ln_wide_least_s"] < f["gelu_wide_least_s"]
    # the f32 program runs the plain composition: no launch, no work count
    assert f["flash_relpos_launches_per_request"] == f["window_pad_rows_per_request"] == 0


@pytest.mark.parametrize("mode", ["control", "fault:no_relpos", "fault:all_global",
                                  "fault:pad_masked", "fault:relpos_swapped",
                                  "fault:pad_before_norm", "fault:altered"])
def test_control_and_faults_fail(tiny_port, mode):
    """The control, each fault but the padding before the norm, and an
    altered token fail the cell's limit here, as at the cell's size. The
    padding before the norm (the padded rows LN1's shift, 0.02 a channel,
    where SAM has zeros) reads under the limit at both sizes, and at least
    a hundred times the f32 program's gap (1e-6 and under) here: a program
    with it is told apart from the plain composition, which the card's
    tests hold the kernels to."""
    out = _run(mode="readings")
    gap = out["numbers"]["token_gap"]
    assert gap < 1e-4
    numbers = {"token_gap": out["readings"][mode]} if mode in out["readings"] else \
        _run(mode=mode)["numbers"]
    if mode in CAUGHT:
        assert not _correct(numbers), numbers
    else:
        assert numbers["token_gap"] > 100 * max(gap, 1e-6), numbers


def test_counts_at_the_tiny_and_the_published_shapes():
    """At the tiny shape: a windowed block's qkv, queries and proj over 81
    rows as SAM computes them and over the grid's 49 in the least, each
    query against the window's 9 keys; at the cell's: 4,900 window rows a
    frame, 5.96 TFLOP a frame, the MLPs 58 % of them."""
    assert counts_sam.window_rows(7, 3) == 81 and counts_sam.window_rows(64, 14) == 4900
    D, H = 160, 640
    attn = counts_sam.attn_flops(81, 9, 3, D)
    assert attn == 9 * (4 * 81 * D + 4 * 9 * 3 * D)
    mlp = 4 * 49 * D * H
    assert counts_sam.block_flops(7, 3, D, H) == 2 * 81 * D * 4 * D + attn + mlp
    assert counts_sam.block_flops(7, 3, D, H, least=True) == (
        2 * 49 * D * 4 * D + counts_sam.attn_flops(49, 9, 3, D) + mlp)
    assert counts_sam.block_flops(7, 0, D, H) == counts_sam.block_flops(7, 0, D, H, least=True)
    assert counts_sam.attn_least_s(1, 112, 16, D, 1, 3, ()) == counts.least_s(
        49 * (4 * 9 * D + 4 * 3 * D), 2 * (2 * 49 * D + 2 * 81 * D))
    cell = harness.load_cell(ROOT, CELL)
    c = cell.config
    flops = counts_sam.model_flops(1024, 16, 1280, 5120, 32, 14, tuple(c["global_attn_indexes"]),
                                   256)
    assert flops == pytest.approx(5.96e12, rel=2e-3)
    assert 32 * 4 * 4096 * 1280 * 5120 / flops == pytest.approx(0.58, abs=0.01)
    work = harness.load_driver(cell).request_work(c, cell.traffic["frames"])
    assert work["flops"] == pytest.approx(8 * flops)
    assert 0 < work["attn80_least_s"] < work["gelu_wide_least_s"] < work["blocks_least_s_samh"]
    # the LayerNorm pass: LN1 of the 4 global blocks and LN2 of all 32
    assert work["ln_wide_least_s"] == 36 * counts_dinov2.ln_wide_least_s(8 * 4096, 1280)
    assert work["blocks_least_s_samh"] < work["flops"] / 989e12 * 1.01


def test_new_readers_are_silent_without_their_kernels():
    """A trace of another program or none at all: each new reader returns
    None; with their kernels a share, the GELU MLP's pass and wide tile told
    from LN1's and proj's by their place around the GELU tile."""
    names = ("block_roofline.samh", "attn80_relpos_roofline.samh", "gelu_wide_roofline.samh")
    readers = {n: harness.load_module(ROOT / "benchmark" / "metrics" / f"{n}.py", n)
               for n in names}
    tr = harness.Trace(0, 10**9, [("flash_bf16_kernel<3, 64>", 0, 10, 1)], [])
    facts = {"trace": tr, "blocks_least_s_samh": 1e-8, "attn80_least_s": 1e-8,
             "gelu_wide_least_s": 1e-8}
    for r in readers.values():
        assert r.read(facts) is None
        assert r.read({"trace": None}) is None
    gelu = "void tt::gemm::gemm_wgmma_kernel<false, 2, 0, 1>(CUtensorMap)"
    tr.device[:] = [("ln_wide_rows_kernel<6>", 0, 10, 7),
                    ("gemm_wgmma_kernel<false, 2, 0, 0>", 10, 20, 7),
                    ("relpos_table_kernel", 20, 25, 7), ("flash_relpos_kernel<64>", 25, 45, 7),
                    ("gemm_wide_kernel", 45, 55, 7), ("ln_wide_rows_kernel<6>", 55, 60, 7),
                    (gelu, 60, 80, 7), ("gemm_wide_kernel", 80, 100, 7)]
    facts.update(attn80_least_s=12.5e-9, gelu_wide_least_s=22.5e-9, blocks_least_s_samh=50e-9)
    assert readers["attn80_relpos_roofline.samh"].read(facts) == pytest.approx(50.0)
    assert readers["gelu_wide_roofline.samh"].read(facts) == pytest.approx(50.0)
    assert readers["block_roofline.samh"].read(facts) == pytest.approx(50.0)
    ln_wide = harness.load_module(ROOT / "benchmark" / "metrics" / "ln_wide_roofline.g14.py",
                                  "ln_wide_roofline.g14")
    assert ln_wide.read({**facts, "ln_wide_least_s": 7.5e-9}) == pytest.approx(50.0)


def test_driver_fails_at_once_on_a_port_without_the_architecture(monkeypatch):
    from timetuning_tpu_torch.models import registry

    monkeypatch.setattr(registry, "ALL_ARCHITECTURES",
                        tuple(a for a in registry.ALL_ARCHITECTURES if a != "sam-vit-h"))
    made = []
    monkeypatch.setattr(ref, "seeded_weights", lambda *a: made.append(a))
    with pytest.raises(SystemExit, match="no backbone 'sam-vit-h'"):
        _run()
    assert not made


def test_cell_found_by_name():
    """The cell, its configuration at the published widths, its traffic
    and limit, its metrics; its driver and readers load no JAX."""
    cell = harness.load_cell(ROOT, CELL)
    c = cell.config
    assert (c["embed_dim"], c["depth"], c["num_heads"], c["mlp_hidden"], c["window_size"],
            c["input_size"], c["out_chans"]) == (1280, 32, 16, 5120, 14, 1024, 256)
    assert c["reduced"] == ["pretrained_weights"] and cell.workload["chips"] == 1
    assert cell.traffic["entry"] == "serve_export_sam" and cell.traffic["frames"] == 8
    assert {e["name"] for e in cell.end_to_end} == {"frames_per_s", "request_ms_p95", "setup_s"}
    assert {p["name"] for p in cell.per_layer} == {
        "mfu.dense", "idle_share.dense", "call_host_ms.serve", "block_roofline.samh",
        "attn80_relpos_roofline.samh", "gelu_wide_roofline.samh", "ln_wide_roofline.g14"}
    assert set(harness.load_limits(cell)) == {"token_gap"}
    probe = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark import harness
harness.load_module(harness.HERE / 'drivers' / 'serve_export_sam.py', 'd')
from timetuning_tpu_torch.cli import export
from timetuning_tpu_torch.models import registry, sam
for m in ('block_roofline.samh', 'attn80_relpos_roofline.samh', 'gelu_wide_roofline.samh'):
    harness.load_module(harness.HERE / 'metrics' / (m + '.py'), m)
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    tops = {m.split(".", 1)[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}
    assert "timetuning_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN_MODULES)
