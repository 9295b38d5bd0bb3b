"""The DINOv3 ViT-7B blocks' kernels of a dense forward against their
roofline: the least time of the cell's blocks' work at its shapes (every
frame of a request through every block: qkv, attention, proj, the SwiGLU
MLP, the RoPE tables read once; bf16 operations at 989 TFLOP/s or bytes once
at 3.35 TB/s, whichever is larger, ``counts_dinov3.blocks_least_s``) over
the device time of the block kernels (the LayerNorm passes, the GEMM tile in
its forms, RoPE's among them, the flash core at heads of 128), both summed
over the program replays whose kernel events the trace kept whole. Unit %."""

from benchmark.harness import complete_share

# the LayerNorm passes, the GEMM tile (RoPE, by turns, wide, SwiGLU), the
# flash core at heads of 128
PATTERNS = ("ln_block_rows_kernel", "ln_wide_rows_kernel", "gemm_rope_kernel",
            "gemm_wgmma_kernel", "gemm_wide_kernel", "gemm_swiglu_kernel",
            "flash_bf16_d128_kernel")


def read(facts: dict):
    tr = facts.get("trace")
    if tr is None or "blocks_least_s_v3" not in facts:
        return None
    return complete_share(tr.groups(PATTERNS), facts["blocks_least_s_v3"])
