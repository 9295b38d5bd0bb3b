#!/usr/bin/env python3
"""How far apart each affinity row's k-th and (k+1)-th dot products lie, in
f64, for normal features drawn as ``chip_smoke.check_propagation`` draws
them at the ViT-S/8 448 eval shape (2 clips x 25 frames x 56 x 56 patches,
D 384, n_last 4, radius 12, top-k 5).

    python tools/propagation_gaps.py SEED [SEED ...]

A row whose two values lie within f32 rounding of each other may keep
another set in two f32 summations of the same products (the plain version
and the kernel), and a flip early in a clip moves the rest of it. For each
seed: the three smallest gaps and how many rows lie under 1e-7 and 1e-6.
``chip_smoke.S8_NORMAL_SEED`` is the seed of 0-40 with the widest smallest
gap. CPU only, four threads, ~20 s a seed.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

B, T, H, W, D, N_LAST, RADIUS, K = 2, 25, 56, 56, 384, 4, 12, 5


def gaps(seed: int) -> torch.Tensor:
    """[B * (T-1) * H * W] f64 gaps between each row's k-th and (k+1)-th
    largest windowed dot product over its live context frames."""
    N = H * W
    yy, xx = np.divmod(np.arange(N), W)
    window = torch.from_numpy((np.abs(yy[:, None] - yy[None]) <= RADIUS)
                              & (np.abs(xx[:, None] - xx[None]) <= RADIUS))
    n_slots = max(min(N_LAST, T - 2), 1)
    rng = np.random.default_rng(seed)
    f = torch.from_numpy(rng.standard_normal((B, T, N, D)).astype(np.float32)).double()
    f = f / (f.norm(dim=-1, keepdim=True) + 1e-12)
    out = []
    for b in range(B):
        for t in range(1, T):
            tops = [(f[b, t] @ f[b, c].T).masked_fill(~window, -10.0).topk(K + 1, dim=1).values
                    for c in [0] + list(range(max(1, t - n_slots), t))]
            v = torch.cat(tops, 1).topk(K + 1, dim=1).values
            out.append(v[:, K - 1] - v[:, K])
    return torch.cat(out)


def main(argv: list[str]) -> int:
    if not argv:
        raise SystemExit(__doc__)
    torch.set_num_threads(4)
    for seed in map(int, argv):
        g = gaps(seed)
        low = g.sort().values[:3].tolist()
        print(f"seed {seed}: smallest gaps {low[0]:.3e} {low[1]:.3e} {low[2]:.3e}; "
              f"rows under 1e-7: {int((g < 1e-7).sum())}, under 1e-6: "
              f"{int((g < 1e-6).sum())}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
