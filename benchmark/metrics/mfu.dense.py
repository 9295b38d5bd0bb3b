"""The dense forward's share of the card's bf16 peak: the model operations
of the frames the window completed (``counts.vit_flops`` a frame: the patch
embedding and every block) over the window and the peak (989 TFLOP/s,
dense, at 700 W). Unit %."""

from benchmark.counts import PEAK_FLOPS


def read(facts: dict):
    if not facts.get("requests"):
        return None
    rate = facts["flops_per_request"] * facts["requests"] / facts["window_s"]
    return 100.0 * rate / (PEAK_FLOPS["bf16"] * facts["chips"])
