"""The DINOv3 cell's driver (``drivers/serve_export_dinov3.py``) at tiny
widths on the CPU (D 256, 2 heads of 128, 20 blocks, the SwiGLU hidden by
DINOv3's rule, 4 storage tokens, f32, 64 x 64 inputs: 21 tokens; at fewer
blocks the control's fp8 reads under the cell's limit): ``correct``
against the reference, the control and each fault caught by the cell's own
limit, the ``readings`` mode's numbers, the new readers silent on a trace
without their kernels, and a set-up path that loads no JAX."""

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

from benchmark import harness
from benchmark.reference import dinov3 as ref

CELL = "serve-v3-7b16-c8"
READERS = ("block_roofline.v3", "attn128_roofline.v3", "ln4096_roofline.v3",
           "qkv_rope_roofline.v3")
TINY = {"name": "tiny-v3", "architecture": "dinov3-vit7b16", "patch_size": 16,
        "embed_dim": 256, "depth": 20, "num_heads": 2, "ffn_hidden": ref.swiglu_hidden(256),
        "n_storage_tokens": 4, "rope_base": 100.0, "input_size": 64, "dtype": "float32",
        "normalize_mean": [0.485, 0.456, 0.406], "normalize_std": [0.228, 0.224, 0.225]}
TRAFFIC = {"entry": "serve_export_dinov3", "frames": 2, "height": 64, "width": 64,
           "bank_clips": 3, "objects": [1, 2], "textured": True, "background": "noise",
           "warm_calls": 2, "sample_p": 1.0, "sample_keep": 2, "compare": 2}


@pytest.fixture
def tiny_port(monkeypatch):
    """The port's ``dinov3-vit7b16`` cut to TINY's widths (its depth comes
    from the configuration, through ``export_features(depth=...)``)."""
    from timetuning_tpu_torch.models import registry, vit

    def tiny(dtype=torch.float32, **kw):
        return dataclasses.replace(vit.dinov3_vit7b(dtype=dtype, **kw), embed_dim=256,
                                   num_heads=2)
    monkeypatch.setattr(registry, "dinov3_vit7b", tiny)


def _run(mode=None, seed=9):
    from benchmark.run import Run

    cell = harness.Cell({"name": "tiny-v3", "chips": 1}, dict(TINY), dict(TRAFFIC), [], [])
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
    assert f["flops_per_request"] > 0 and 0 < f["attn128_least_s"] < f["blocks_least_s_v3"]
    assert 0 < f["qkv_rope_least_s"] < f["blocks_least_s_v3"]
    assert 0 < f["swiglu_least_s"] < f["blocks_least_s_v3"]
    # the port counts no launch on the CPU
    assert all(f[f"{e}_launches_per_request"] == 0 for e in
               ("ln_rope_dense", "flash_d128", "swiglu_mlp", "dense_residual"))


@pytest.mark.parametrize("mode", ["control", "fault:no_rope", "fault:rope_on_prefix",
                                  "fault:no_layerscale", "fault:altered"])
def test_control_and_faults_fail(tiny_port, mode):
    """Each caught by the cell's limit at these 21 tokens."""
    broken = _run(mode=mode)["numbers"]
    assert not _correct(broken), broken


def test_readings_mode_reports_each_control_and_fault(tiny_port):
    """One set-up, the program's gap as the run's number and the control's
    and each fault's beside it: the same numbers as their own runs give."""
    out = _run(mode="readings")
    got = out["readings"]
    assert set(got) == {"control", "fault:no_rope", "fault:rope_on_prefix",
                        "fault:no_layerscale"}
    assert out["numbers"]["token_gap"] < 1e-4
    alone = _run(mode="fault:no_rope")["numbers"]["token_gap"]
    assert got["fault:no_rope"] == pytest.approx(alone)


def test_request_work_at_the_cell():
    """The cell's own configuration: 3,141 tokens, 97.6 TFLOP a request of 8
    frames through 10 blocks (the model's operations; about 99 ms at the
    bf16 peak); attention is 13 % of a block's operations."""
    from benchmark import counts_dinov3

    cell = harness.load_cell(ROOT, CELL)
    work = harness.load_driver(cell).request_work(cell.config, cell.traffic["frames"])
    assert counts_dinov3.tokens(896, 16, 4) == 3141
    assert work["flops"] == pytest.approx(97.6e12, rel=5e-3)
    attn = 4 * 3141 ** 2 * 4096
    assert 0.12 < attn / counts_dinov3.block_flops(3141, 4096, 8192) < 0.14
    assert 0.095 < work["blocks_least_s_v3"] < 0.1
    assert work["attn128_least_s"] < work["blocks_least_s_v3"]
    assert work["ln4096_least_s"] == pytest.approx(20 * 2 * 2 * 8 * 3141 * 4096 / 3.35e12,
                                                   rel=1e-3)
    # the two largest tiles, bound by their operations: qkv 3 D^2, w12 2 D Hd a row
    assert work["qkv_rope_least_s"] == pytest.approx(10 * 2 * 8 * 3141 * 4096 * 12288 / 989e12,
                                                     rel=1e-3)
    assert work["swiglu_least_s"] == pytest.approx(10 * 2 * 8 * 3141 * 4096 * 16384 / 989e12,
                                                   rel=1e-3)


def test_new_readers_are_silent_without_their_kernels():
    """A trace of another program (the g14 cell's kernels) or none at all:
    each new reader returns None; with its kernel and facts, a share."""
    tr = harness.Trace(0, 10**9, [("gemm_swiglu_kernel_wide", 0, 10, 1),
                                  ("flash_bf16_kernel<3, 64>", 10, 20, 1),
                                  ("ln_wide_rows_kernel<6>", 20, 25, 1)], [])
    facts = {"trace": tr, "blocks_least_s_g14": 1e-8}
    for name in READERS:
        reader = harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", name)
        assert reader.read(facts) is None
        assert reader.read({"trace": None}) is None
    facts.update(blocks_least_s_v3=1e-8, attn128_least_s=5e-9, ln4096_least_s=1e-9,
                 qkv_rope_least_s=3e-9)
    tr.device.append(("flash_bf16_d128_kernel", 30, 40, 1))
    tr.device.append(("ln_block_rows_kernel<2>", 40, 42, 1))
    tr.device.append(("gemm_rope_kernel_wide", 42, 48, 1))
    attn = harness.load_module(ROOT / "benchmark" / "metrics" / "attn128_roofline.v3.py", "a")
    ln = harness.load_module(ROOT / "benchmark" / "metrics" / "ln4096_roofline.v3.py", "l")
    qkv = harness.load_module(ROOT / "benchmark" / "metrics" / "qkv_rope_roofline.v3.py", "q")
    assert attn.read(facts) == pytest.approx(50.0)
    assert ln.read(facts) == pytest.approx(50.0)
    assert qkv.read(facts) == pytest.approx(50.0)
    # the g14 readers do not count the new kernels
    g14 = harness.load_module(ROOT / "benchmark" / "metrics" / "ln_wide_roofline.g14.py", "g")
    other = harness.Trace(0, 10**9, [("ln_block_rows_kernel<2>", 0, 9, 1)], [])
    assert g14.read({"trace": other, "ln_wide_least_s": 1e-9}) is None


def test_manifest_has_the_cell_and_its_metrics():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in m["workloads"]}
    assert cells[CELL]["config"] == "dinov3-vit7b16-896" and cells[CELL]["chips"] == 1
    cell = harness.load_cell(ROOT, CELL)
    assert {e["name"] for e in cell.end_to_end} == {"frames_per_s", "request_ms_p95", "setup_s"}
    assert {p["name"] for p in cell.per_layer} == {"mfu.dense", "idle_share.dense",
                                                   "call_host_ms.serve", "swiglu_roofline.g14",
                                                   *READERS}
    assert cell.config["reduced"] == ["pretrained_weights", "depth"]
    assert harness.load_limits(cell)["token_gap"] > 0


def test_driver_set_up_loads_no_jax():
    probe = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark import harness
harness.set_cache_dirs(harness.HERE.parent)
harness.load_module(harness.HERE / 'drivers' / 'serve_export_dinov3.py', 'd')
from timetuning_tpu_torch.cli import export
from timetuning_tpu_torch.models import registry
for m in {READERS!r}:
    harness.load_module(harness.HERE / 'metrics' / (m + '.py'), m)
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    tops = {m.split(".", 1)[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}
    assert "timetuning_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN_MODULES)
