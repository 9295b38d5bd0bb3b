"""SAM ViT-H's GELU MLP at D 1,280 against its roofline: the LayerNorm pass
(``ln_wide_rows_kernel``), the streamed tile with the bias-GELU epilogue
(``gemm_wgmma_kernel<false, 2, 0, 1>``: lin1, hidden 5,120) and lin2 + the
residual (``gemm_wide_kernel``) of the 32 MLPs a request, told from LN1's
pass and proj's wide tile (the same kernels) by their place in a replay:
the pass just before a GELU tile and the wide tile just after it. Their
least time (``counts_sam.gelu_mlp_least_s``: each launch's bytes or
operations, whichever bounds it, at 3.35 TB/s and 989 TFLOP/s) over their
device time, both summed over the replays whose kernel events the trace
kept whole. None where no GELU tile ran. Unit %."""

from benchmark.harness import complete_share

GELU = "gemm_wgmma_kernel<false, 2, 0, 1>"


def read(facts: dict):
    tr = facts.get("trace")
    if tr is None or "gelu_wide_least_s" not in facts:
        return None
    by_replay: dict = {}
    for name, a, b, corr in tr.device:
        by_replay.setdefault(corr, []).append((a, b, name))
    groups = {}
    for corr, events in by_replay.items():
        events.sort()
        n, t = 0, 0.0
        for i, (a, b, name) in enumerate(events):
            if GELU not in name:
                continue
            n, t = n + 1, t + (b - a) / 1e9
            if i > 0 and "ln_wide_rows_kernel" in events[i - 1][2]:
                n, t = n + 1, t + (events[i - 1][1] - events[i - 1][0]) / 1e9
            if i + 1 < len(events) and "gemm_wide_kernel" in events[i + 1][2]:
                n, t = n + 1, t + (events[i + 1][1] - events[i + 1][0]) / 1e9
        if n:
            groups[corr] = (n, t)
    return complete_share(groups, facts["gelu_wide_least_s"])
