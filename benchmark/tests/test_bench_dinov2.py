"""The DINOv2 cell's driver (``drivers/serve_export_dinov2.py``) at tiny
widths on the CPU (D 64, 8 blocks, heads of 32, the SwiGLU hidden by
DINOv2's rule, 4 registers, f32, 98 x 98 inputs: 54 tokens; at fewer blocks
the control's fp8 stays under the cell's limit): ``correct`` against the
reference, the control and each fault caught by the cell's own limits, the
new readers silent on a trace without their kernels, and a set-up path that
loads no JAX."""

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
from benchmark.reference import dinov2 as ref

CELL = "serve-g14reg-c25"
TINY = {"name": "tiny-g14", "architecture": "dinov2-g14-reg", "patch_size": 14,
        "embed_dim": 64, "depth": 8, "num_heads": 2, "ffn_hidden": ref.swiglu_hidden(64),
        "n_registers": 4, "pos_embed_size": 56, "input_size": 98, "dtype": "float32",
        "normalize_mean": [0.485, 0.456, 0.406], "normalize_std": [0.228, 0.224, 0.225]}
TRAFFIC = {"entry": "serve_export_dinov2", "frames": 3, "height": 98, "width": 98,
           "bank_clips": 3, "objects": [1, 2], "textured": True, "background": "noise",
           "warm_calls": 2, "sample_p": 1.0, "sample_keep": 2, "compare": 2}


@pytest.fixture
def tiny_port(monkeypatch):
    """The port's ``dinov2-g14-reg`` cut to TINY's widths and depth."""
    from timetuning_tpu_torch.models import registry, vit

    def tiny(dtype=torch.float32, **kw):
        return dataclasses.replace(vit.dinov2_giant_reg(dtype=dtype, **kw), embed_dim=64,
                                   depth=8, num_heads=2, img_size=56)
    monkeypatch.setattr(registry, "dinov2_giant_reg", tiny)


def _run(mode=None, seed=9):
    from benchmark.run import Run

    cell = harness.Cell({"name": "tiny-g14", "chips": 1}, dict(TINY), dict(TRAFFIC), [], [])
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
    assert f["flops_per_request"] > 0 and f["swiglu_least_s"] > 0
    # the port counts no launch on the CPU
    assert f["swiglu_mlp_launches_per_request"] == f["ln_wide_dense_launches_per_request"] == 0


@pytest.mark.parametrize("mode", ["control", "fault:no_layerscale", "fault:no_registers",
                                  "fault:altered"])
def test_control_and_faults_fail(tiny_port, mode):
    """Each caught by the cell's limit at these 54 tokens. ``no_registers``
    is caught only at such small token counts, where 4 registers carry
    weight in the attention: at the cell's 1,029 tokens it reads under the
    program's own gap, so the cell's comparison does not see it there (the
    card test of the registers in ``tests/test_torch_dinov2.py`` does)."""
    broken = _run(mode=mode)["numbers"]
    assert not _correct(broken), broken


def test_request_work_at_the_cell():
    """The cell's own configuration: 1,029 tokens, 64.8 TFLOP a request
    (the model's operations; about 65.5 ms at the bf16 peak)."""
    from benchmark import counts_dinov2

    cell = harness.load_cell(ROOT, CELL)
    work = harness.load_driver(cell).request_work(cell.config, cell.traffic["frames"])
    assert counts_dinov2.tokens(448, 14, 4) == 1029
    assert work["flops"] == pytest.approx(64.82e12, rel=1e-3)
    assert 0.064 < work["blocks_least_s_g14"] < 0.067
    assert work["swiglu_least_s"] < work["blocks_least_s_g14"]


def test_new_readers_are_silent_without_their_kernels():
    """A trace of another program (the S/8 cell's kernels) or none at all:
    each new reader returns None."""
    tr = harness.Trace(0, 10**9, [("gemm_wide_kernel", 0, 10, 1),
                                  ("flash_bf16_kernel<3, 64>", 10, 20, 1)], [])
    facts = {"trace": tr, "block_least_s": 1e-6}
    for name in ("block_roofline.g14", "swiglu_roofline.g14", "ln_wide_roofline.g14"):
        reader = harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", name)
        assert reader.read(facts) is None
        assert reader.read({"trace": None}) is None
    # with its facts and kernels, a share
    facts.update(swiglu_least_s=5e-9, blocks_least_s_g14=1e-8, ln_wide_least_s=1e-9)
    tr.device.append(("gemm_swiglu_kernel", 20, 30, 1))
    share = harness.load_module(ROOT / "benchmark" / "metrics" / "swiglu_roofline.g14.py",
                                "s").read(facts)
    assert share == pytest.approx(50.0)


def test_driver_set_up_loads_no_jax():
    probe = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark import harness
harness.set_cache_dirs(harness.HERE.parent)
harness.load_module(harness.HERE / 'drivers' / 'serve_export_dinov2.py', 'd')
from timetuning_tpu_torch.cli import export
from timetuning_tpu_torch.models import registry
for m in ('block_roofline.g14', 'swiglu_roofline.g14', 'ln_wide_roofline.g14'):
    harness.load_module(harness.HERE / 'metrics' / (m + '.py'), m)
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    tops = {m.split(".", 1)[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}
    assert "timetuning_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN_MODULES)
