"""The heads-of-80 core with SAM's decomposed relative-position bias
(``flash_relpos_kernel`` and the bias tables it reads,
``relpos_table_kernel``: 28 windowed launches over 8 x 25 windows of 196
tokens and 4 global ones over 8 frames of 4,096 a request) against its
roofline: its least time at the cell's shapes (``counts_sam.attn_least_s``:
the scores, values and bias products of the grid's 4,096 queries a frame,
the padded keys among the keys, at 989 TFLOP/s, or q, k, v and the output
once at 3.35 TB/s, whichever is larger, summed over the 32 blocks),
over the two kernels' device time, both summed over the replays whose
kernel events the trace kept whole. None where no such kernel ran. Unit
%."""

from benchmark.harness import complete_share


def read(facts: dict):
    tr = facts.get("trace")
    if tr is None or "attn80_least_s" not in facts:
        return None
    return complete_share(tr.groups(("flash_relpos_kernel", "relpos_table_kernel")),
                          facts["attn80_least_s"])
