"""The ViT blocks' kernels of a dense forward against their roofline: the
least time of the blocks' work at the cell's shapes (every frame of a
request through every block; bf16 operations at 989 TFLOP/s or bytes once
at 3.35 TB/s, whichever is larger, ``counts.blocks_least_s``) over the
device time of the block kernels (K1 + K2 up to 1,024 tokens; K7, K5/6,
K8, K9 above), both summed over the program replays whose kernel events
the trace kept whole. Unit %."""

from benchmark.harness import complete_share

# the GEMM tile (K1's and K2's products), the attention cores (K1, K5/6)
PATTERNS = ("gemm_wgmma_kernel", "gemm_wide_kernel", "mha_one_pass_kernel",
            "mha_two_pass_kernel", "flash_bf16_kernel")


def read(facts: dict):
    tr = facts.get("trace")
    if tr is None:
        return None
    return complete_share(tr.groups(PATTERNS), facts["block_least_s"])
