"""The LayerNorm pass of a block a row (``ln_block_rows_kernel``: LN1 and
LN2 of each DINOv3 ViT-7B block at 4,096-wide rows and eps 1e-5, two
launches a block) against its roofline: the rows in and out once and the
scale and bias at 3.35 TB/s (``counts_dinov3.ln_least_s``), over its device
time, both summed over the replays whose kernel events the trace kept whole.
None where no such kernel ran. Unit %."""

from benchmark.harness import complete_share


def read(facts: dict):
    tr = facts.get("trace")
    if tr is None or "ln4096_least_s" not in facts:
        return None
    return complete_share(tr.groups(("ln_block_rows_kernel",)), facts["ln4096_least_s"])
