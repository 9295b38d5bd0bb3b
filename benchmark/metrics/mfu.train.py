"""The whole training step's share of the card's bf16 peak: the model
operations a step requires (``counts.train_step_flops``: the ViT over every
frame, the teacher's and student's tails and heads, the backward of the
trained blocks and head, the propagation), times the steps of the window,
over the window and the peak (989 TFLOP/s a card, dense, at 700 W). Unit %."""

from benchmark.counts import PEAK_FLOPS


def read(facts: dict):
    if not facts.get("steps"):
        return None
    rate = facts["flops_per_step"] * facts["steps"] / facts["window_s"]
    return 100.0 * rate / (PEAK_FLOPS["bf16"] * facts["chips"])
