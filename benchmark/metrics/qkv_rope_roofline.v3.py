"""The qkv product with the RoPE epilogue (``gemm_rope_kernel_wide``, or
``gemm_rope_kernel`` by turns: LN1's rows of DINOv3 ViT-7B times ``w_qkv``,
q and k of the patch tokens rotated before the one rounding, one launch a
block) against its roofline: its least time at the cell's shapes
(``counts_dinov3.qkv_rope_least_s``: the operations at 989 TFLOP/s, or the
rows, ``w_qkv``, the output and the RoPE tables once at 3.35 TB/s, whichever
is larger), over its device time, both summed over the replays whose kernel
events the trace kept whole. None where no such kernel ran. Unit %."""

from benchmark.harness import complete_share


def read(facts: dict):
    tr = facts.get("trace")
    if tr is None or "qkv_rope_least_s" not in facts:
        return None
    return complete_share(tr.groups(("gemm_rope_kernel",)), facts["qkv_rope_least_s"])
