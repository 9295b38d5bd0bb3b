"""The flash core at heads of 128 (``flash_bf16_d128_kernel``: DINOv3
ViT-7B's 32 heads over 3,141 tokens, one launch a block, RoPE applied
before it by the qkv product) against its roofline: its least time at the
cell's shapes (``counts_dinov3.attn_least_s``: 4 T^2 D operations a frame at
989 TFLOP/s, or q, k, v and the output once at 3.35 TB/s, whichever is
larger), over its device time, both summed over the replays whose kernel
events the trace kept whole. None where no such kernel ran. Unit %."""

from benchmark.harness import complete_share


def read(facts: dict):
    tr = facts.get("trace")
    if tr is None or "attn128_least_s" not in facts:
        return None
    return complete_share(tr.groups(("flash_bf16_d128_kernel",)), facts["attn128_least_s"])
