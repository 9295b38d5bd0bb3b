"""SAM ViT-H's blocks' kernels of a dense forward against their roofline:
the least time of the cell's blocks' work at its shapes (every frame of a
request through all 32 blocks: qkv, the attention's queries, proj and the
GELU MLP over the grid's rows, each query against its window's keys, the
padded ones among them; bf16
operations at 989 TFLOP/s or bytes once at 3.35 TB/s, whichever is larger,
``counts_sam.blocks_least_s``) over the device time of the block kernels
(the LayerNorm passes, in window order among them, the GEMM tile in its
forms, the heads-of-80 core and its bias tables), both summed over the
program replays whose kernel events the trace kept whole. None where no
such kernel ran. Unit %."""

from benchmark.harness import complete_share

PATTERNS = ("ln_window_rows_kernel", "ln_wide_rows_kernel", "gemm_wgmma_kernel",
            "gemm_wide_kernel", "relpos_table_kernel", "flash_relpos_kernel")


def read(facts: dict):
    tr = facts.get("trace")
    if tr is None or "blocks_least_s_samh" not in facts:
        return None
    return complete_share(tr.groups(PATTERNS), facts["blocks_least_s_samh"])
