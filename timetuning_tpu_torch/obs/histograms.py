"""Prototype-assignment diagnostics.

Counterpart of ``timetuning_tpu/obs/histograms.py`` (reference
time_tuning.py:433-457 and my_utils: ``get_similarity_histogram``
accumulates the argmax-prototype histogram over an eval loader,
``log_assignment_histogram`` writes the distribution and its entropy). The
histogram is one ``bincount`` a batch on the scores' device.
"""

from __future__ import annotations

import numpy as np
import torch


def assignment_histogram(scores: torch.Tensor, num_prototypes: int) -> torch.Tensor:
    """[..., K] prototype scores -> [K] argmax counts (on the scores' device)."""
    assign = scores.reshape(-1, scores.shape[-1]).argmax(dim=-1)
    return torch.bincount(assign, minlength=num_prototypes)[:num_prototypes]


def assignment_entropy(hist: np.ndarray) -> float:
    """Mean -p log(p) of the assignment distribution (reference
    log_assignment_histogram, time_tuning.py:437-441)."""
    p = np.asarray(hist, np.float64)
    p = p / max(p.sum(), 1.0)
    return float(-(p * np.log(p + 1e-8)).mean())


def collect_assignment_histogram(feature_fn, similarity_fn, loader,
                                 num_prototypes: int) -> np.ndarray:
    """Accumulate the histogram over a loader (reference
    ``get_similarity_histogram``). ``feature_fn(frames) -> [B, N, D]``,
    ``similarity_fn(feats) -> [B, N, K]``."""
    hist = np.zeros(num_prototypes, np.int64)
    for batch in loader:
        scores = similarity_fn(feature_fn(batch[0]))
        hist += assignment_histogram(scores, num_prototypes).cpu().numpy()
    return hist


def log_assignment_histogram(writer, hist: np.ndarray, step: int) -> float:
    """Write the distribution and its entropy (time_tuning.py:433-442).
    Returns the entropy."""
    ent = assignment_entropy(hist)
    writer.scalar("Scores/entropy", ent, step)
    writer.histogram("Assignment Histogram", hist, step)
    return ent
