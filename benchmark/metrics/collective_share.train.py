"""Share of the traced training window that rank 0's card spends in NCCL
kernels (``parallel/mesh`` over NCCL: the gradient all-reduce of
``core/timet`` and K11's cross-rank all-reduces). Unit %."""

PATTERNS = ("nccl", "ncclDevKernel")


def read(facts: dict):
    tr = facts.get("trace")
    if tr is None or facts.get("chips", 1) < 2:
        return None
    s = sum(t for name, t in tr.by_kernel().items() if any(p in name for p in PATTERNS))
    return 100.0 * s / tr.window_s
