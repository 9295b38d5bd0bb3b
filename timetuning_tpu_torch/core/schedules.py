"""Training schedules, precomputed as numpy arrays indexed by step.

The port's own copy of ``timetuning_tpu/core/schedules.py`` (reference
my_utils.py:278-283, time_tuning.py:121-122, 427-429); ``schedule_at`` takes
a host integer step.
"""

from __future__ import annotations

import numpy as np


def cosine_scheduler(base_value: float, final_value: float, epochs: int,
                     niter_per_ep: int, warmup_epochs: int = 0,
                     start_warmup_value: float = 0.0) -> np.ndarray:
    """Cosine schedule from ``base_value`` to ``final_value`` over
    ``epochs * niter_per_ep`` steps, with an optional linear warm-up
    (reference ``cosine_scheduler``, my_utils.py:278-283; the reference only
    uses warmup_epochs=0: EMA momentum 0.995 -> 1.0, time_tuning.py:614-616,
    and weight decay 0.04 -> 0.4, :383-386)."""
    warmup_iters = warmup_epochs * niter_per_ep
    total = epochs * niter_per_ep
    warmup = np.linspace(start_warmup_value, base_value, warmup_iters)
    iters = np.arange(total - warmup_iters)
    cosine = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(np.pi * iters / max(len(iters), 1)))
    out = np.concatenate([warmup, cosine])
    assert len(out) == total
    return out


def cosine_annealing_lr(base_lr: float, total_steps: int,
                        eta_min: float = 0.0) -> np.ndarray:
    """PyTorch ``CosineAnnealingLR(T_max=total_steps)`` values per step
    (reference optimizer scheduler, time_tuning.py:383-386)."""
    steps = np.arange(total_steps)
    return eta_min + (base_lr - eta_min) * (1 + np.cos(np.pi * steps / total_steps)) / 2


def schedule_at(schedule: np.ndarray, step: int) -> float:
    """The schedule's value at ``step``, clamped to the last entry."""
    return float(schedule[min(int(step), len(schedule) - 1)])
