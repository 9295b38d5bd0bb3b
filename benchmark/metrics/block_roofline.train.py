"""The ViT blocks' kernels in the training step against their roofline:
the least time of the no-grad blocks' work at the cell's shapes (every
frame through all blocks, the teacher's trained blocks on the first frame;
bf16 operations at 989 TFLOP/s or bytes once at 3.35 TB/s, whichever is
larger, ``counts.blocks_least_s``) over the device time of the block
kernels, both summed over the step replays whose kernel events the trace
kept whole. Unit %."""

from benchmark.harness import complete_share

# the GEMM tile (K1's and K2's products), the attention cores (K1, K5/6)
PATTERNS = ("gemm_wgmma_kernel", "gemm_wide_kernel", "mha_one_pass_kernel",
            "mha_two_pass_kernel", "flash_bf16_kernel")


def read(facts: dict):
    tr = facts.get("trace")
    if tr is None:
        return None
    return complete_share(tr.groups(PATTERNS), facts["block_least_s"])
