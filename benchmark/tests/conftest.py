"""Tiny cells for the benchmark's CPU tests: the drivers and references at
the test ViT's widths (D 32, 2 blocks, patch 8, 32 x 32 inputs)."""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"name": "tiny", "architecture": "vit-tiny-test", "patch_size": 8, "embed_dim": 32,
        "depth": 2, "num_heads": 2, "mlp_ratio": 4.0, "pos_embed_size": 32,
        "input_size": 32, "head_dims": [64, 32], "n_prototypes": 10,
        "unfreeze_layers": ["blocks.1"], "dtype": "float32",
        "normalize_mean": [0.485, 0.456, 0.406], "normalize_std": [0.228, 0.224, 0.225]}

TRAFFIC = {
    "train": {"entry": "timet_train", "videos": 8, "batch": 2, "frames": 4,
              "decode_size": 40, "native_size": [72, 128], "num_workers": 1,
              "num_epochs": 100, "bank_clips": 4, "objects": [2, 2], "textured": False,
              "background": "gradient", "warm_steps": 3},
    "train_dp": {"entry": "timet_train_dp", "videos": 8, "batch": 2, "frames": 4,
                 "decode_size": 40, "native_size": [72, 128], "num_workers": 1,
                 "num_epochs": 100, "bank_clips": 4, "objects": [2, 2], "textured": False,
                 "background": "gradient", "warm_steps": 3},
    "serve": {"entry": "serve_export", "frames": 3, "height": 32, "width": 32,
              "bank_clips": 3, "objects": [1, 2], "textured": True, "background": "noise",
              "warm_calls": 2, "sample_p": 1.0, "sample_keep": 2, "compare": 2}
}


def tiny_run(kind: str, seed: int = 7, mode=None, seconds: float = 0.5, trace: bool = False) -> dict:
    """One run of the tiny cell of ``kind`` on the CPU, its driver's whole
    output (no look for a card)."""
    import torch

    from benchmark import harness
    from benchmark.run import Run

    chips = 2 if kind == "train_dp" else 1
    cell = harness.Cell({"name": f"tiny-{kind}", "chips": chips}, dict(TINY), TRAFFIC[kind], [], [])
    driver = harness.load_driver(cell)
    with tempfile.TemporaryDirectory() as work_dir:
        run = Run(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                  work_dir)
        run.mode = mode
        return driver.run(run)


@pytest.fixture
def card():
    """The test needs a CUDA card; decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda", 0)
