# The port's own copy of timetuning_tpu/obs/logging.py (host code, no JAX), with its
# imports of the package renamed; tests/test_torch_host_copies.py pins it to the original.
"""Metrics/observability: TensorBoard scalars, config capture, file logging.

Reference: rank-0 ``SummaryWriter(logs/YYYYMMDD/HHMMSS)`` with
``Loss/train`` per step and ``Scores/localization`` per eval
(time_tuning.py:555-566, 665, 645); argparse dump to ``config.txt``
(:567-570); per-run FileHandler loggers (evaluation.py:365-370). wandb is
optional and gated (my_utils.py:139-143).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Mapping


class MetricsWriter:
    """TensorBoard scalar writer with a JSONL mirror.

    The JSONL mirror (``metrics.jsonl``) makes runs greppable without TB and
    is the canonical record for CI; TB is used when available.
    """

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception:
                self._tb = None
        self._wandb = None

    def init_wandb(self, project: str, config: Mapping[str, Any] | None = None):
        try:
            import wandb

            self._wandb = wandb.init(project=project, config=dict(config or {}))
        except Exception:
            self._wandb = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        v = float(value)
        if v != v or v in (float("inf"), float("-inf")):
            # json.dumps would emit NaN/Infinity tokens — INVALID JSON that
            # breaks jq/strict parsers exactly on the diverged runs worth
            # inspecting; record the value as a string instead
            v = str(v)
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": v, "step": int(step)}
        ) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        if self._wandb is not None:
            self._wandb.log({tag: value}, step=step)

    def histogram(self, tag: str, values, step: int) -> None:
        import numpy as np

        self._jsonl.write(json.dumps({
            "tag": tag, "step": int(step),
            "histogram": np.asarray(values).astype(float).tolist(),
        }) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_histogram(tag, values, step)

    def image(self, tag: str, img, step: int) -> None:
        """img: [H, W, 3] float in [0,1] or uint8."""
        if self._tb is not None:
            self._tb.add_image(tag, img, step, dataformats="HWC")

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def dump_config(config: Mapping[str, Any], run_dir: str) -> str:
    """All run flags → ``config.txt`` (reference time_tuning.py:567-570)."""
    path = os.path.join(run_dir, "config.txt")
    with open(path, "w") as f:
        for k in sorted(config):
            f.write(f"{k}: {config[k]}\n")
    return path


def make_file_logger(name: str, run_dir: str) -> logging.Logger:
    """Per-run parameterized file logger (reference evaluation.py:365-370).

    Re-calling with a NEW run_dir in the same process (multi-run sweeps,
    test suites) retargets the handler — a name-only guard would pin the
    logger to the first run's directory forever."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    target = os.path.abspath(os.path.join(run_dir, f"{name}.log"))
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler):
            if os.path.abspath(h.baseFilename) == target:
                return logger
            logger.removeHandler(h)
            h.close()
    h = logging.FileHandler(target)
    h.setFormatter(
        logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    )
    logger.addHandler(h)
    return logger
