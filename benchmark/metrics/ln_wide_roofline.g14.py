"""The LayerNorm pass of rows wider than the GEMM tile's prologue holds
(``ln_wide_rows_kernel``: LN1 and LN2 of each DINOv2 ViT-g block, 80 launches
a request) against its roofline: the rows in and out once and the scale and
bias at 3.35 TB/s (``counts_dinov2.ln_wide_least_s``), over its device time,
both summed over the replays whose kernel events the trace kept whole. None
where no such kernel ran. Unit %."""

from benchmark.harness import complete_share


def read(facts: dict):
    tr = facts.get("trace")
    if tr is None or "ln_wide_least_s" not in facts:
        return None
    return complete_share(tr.groups(("ln_wide_rows_kernel",)), facts["ln_wide_least_s"])
