"""The GEMM tile's SwiGLU form (``gemm_swiglu_kernel``: LN2's rows times
``w12``, ``silu(a) * b`` written as the bf16 hidden) against its roofline:
its least time at the cell's shapes, 40 launches a request
(``counts_dinov2.swiglu_least_s``: the operations at 989 TFLOP/s or the
rows, ``w12`` and the hidden once at 3.35 TB/s, whichever is larger), over
its device time, both summed over the replays whose kernel events the trace
kept whole. None where no such kernel ran (a port without it). Unit %."""

from benchmark.harness import complete_share


def read(facts: dict):
    tr = facts.get("trace")
    if tr is None or "swiglu_least_s" not in facts:
        return None
    return complete_share(tr.groups(("gemm_swiglu_kernel",)), facts["swiglu_least_s"])
