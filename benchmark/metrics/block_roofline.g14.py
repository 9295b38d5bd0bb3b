"""The DINOv2 ViT-g blocks' kernels of a dense forward against their
roofline: the least time of the 40 blocks' work at the cell's shapes (every
frame of a request through every block: qkv, attention, proj, the SwiGLU
MLP; bf16 operations at 989 TFLOP/s or bytes once at 3.35 TB/s, whichever is
larger, ``counts_dinov2.blocks_least_s``) over the device time of the block
kernels (the LayerNorm pass, the GEMM tile in its forms, the attention
cores), both summed over the program replays whose kernel events the trace
kept whole. Unit %."""

from benchmark.harness import complete_share

# the LayerNorm pass, the GEMM tile (by turns, wide, SwiGLU), the attention
# cores (flash above 1,024 tokens, kernel 10 below)
PATTERNS = ("ln_wide_rows_kernel", "gemm_wgmma_kernel", "gemm_wide_kernel",
            "gemm_swiglu_kernel", "flash_bf16_kernel", "mha_one_pass_kernel",
            "mha_two_pass_kernel")


def read(facts: dict):
    tr = facts.get("trace")
    if tr is None or "blocks_least_s_g14" not in facts:
        return None
    return complete_share(tr.groups(PATTERNS), facts["blocks_least_s_g14"])
