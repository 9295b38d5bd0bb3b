"""The plain reference of TimeT's training step (Salehi et al., ICCV 2023,
``time_tuning.py``), in float32 (or with fp8 products: the control).

One step on a batch of uint8 clips:
  1. the augmentation (``augment``) with the step's draws;
  2. the ViT over every frame: the frozen blocks, then the trained ones and
     the final norm: the propagation's features;
  3. the teacher (EMA) tail and head on each clip's first frame; scores
     against the teacher's prototypes; the Sinkhorn assignment;
  4. the assignment propagated through the clip; each patch's label the
     argmax of the last frame's map;
  5. the student's tail and head on the last frame, the cross-entropy of
     its prototype scores / 0.1 against the labels, its gradients;
  6. AdamW (b 0.9 / 0.999, eps 1e-8; the head and prototypes at lr, the
     trained blocks at lr / 10; lr cosine to 0 over the run, weight decay
     cosine 0.04 -> 0.4, none on biases and 1-D leaves), the prototypes
     renormalised, the teacher ``t (1 - m) + s m`` with m cosine 0.995 -> 1.

The step's random draws come from the run's seed, the step's index and the
data rank as the driver derives them (a SeedSequence of (seed, 0x57E9,
step), and the rank after it on ranks other than 0). Over data-parallel
ranks the step is the one-device step on the global batch, the ranks'
slices in rank order, each slice augmented with its own rank's draws.

Imports nothing of the program, of JAX, or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import augment as aug
from benchmark.reference import vit
from benchmark.reference.propagation import propagate, sinkhorn

_B1, _B2, _EPS = 0.9, 0.999, 1e-8
BB = "feature_extractor.backbone."
HEAD = "feature_extractor.head."


@dataclasses.dataclass(frozen=True)
class TrainShape:
    vit: vit.ViTShape
    head_dims: tuple
    n_prototypes: int
    trained_blocks: tuple          # block indices that train
    lr: float
    num_epochs: int
    steps_per_epoch: int
    input_size: int = 224
    n_last: int = 7
    radius: int = 6
    topk: int = 5
    epsilon: float = 0.05
    sinkhorn_iters: int = 10
    temperature: float = 0.1


def step_generator(seed: int, step: int, rank: int = 0) -> torch.Generator:
    entropy = [seed, 0x57E9, step] + ([rank] if rank else [])
    s = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(s))


def _cosine(base: float, final: float, total: int, step: int) -> float:
    i = min(step, total - 1)
    return final + 0.5 * (base - final) * (1 + math.cos(math.pi * i / max(total, 1)))


def trains(name: str, s: TrainShape) -> bool:
    if not name.startswith(BB):
        return True
    return any(name.startswith(f"{BB}blocks.{i}.") for i in s.trained_blocks)


def decays(name: str, shape) -> bool:
    return len(shape) > 1 and not name.endswith("bias")


class Trainer:
    """The state of a reference run (parameters, teacher, AdamW moments) and
    its step. ``quant="fp8"``: every matrix product with fp8 operands."""

    def __init__(self, s: TrainShape, params: dict, device, quant=None):
        self.s, self.quant, self.device = s, quant, device
        self.p = {k: v.detach().to(device, torch.float32).clone() for k, v in params.items()}
        self.names = [k for k in self.p if trains(k, s)]
        self.teacher = {k: self.p[k].clone() for k in self.names}
        self.m = {k: torch.zeros_like(self.p[k]) for k in self.names}
        self.v = {k: torch.zeros_like(self.p[k]) for k in self.names}
        self.count = 0
        self.first_grads: dict | None = None

    def _tail(self, params, x, with_head: bool):
        s = self.s
        x = vit.blocks(params, x, s.vit, min(s.trained_blocks), s.vit.depth, BB, self.quant)
        f = vit.final_norm(params, x, BB)
        if with_head:
            f = vit.head(params, f, len(s.head_dims), HEAD, self.quant)
        return f

    def _similarity(self, feats, protos):
        f = feats / (torch.linalg.vector_norm(feats, dim=-1, keepdim=True) + 1e-12)
        a, b = vit._mm_operands(f, protos, self.quant)
        return a @ b.t()

    def step(self, frames_u8, sizes, gray_means, generators) -> float:
        """One step on the global batch; ``generators`` draws each rank's
        slice of it (one generator: one rank)."""
        s = self.s
        B, T = frames_u8.shape[:2]
        if isinstance(generators, torch.Generator):
            generators = [generators]
        table = torch.cat([aug.draw(g, B // len(generators), T) for g in generators])
        clips = aug.augment(frames_u8.to(self.device), table, sizes, gray_means, s.input_size)
        H, W = clips.shape[2:4]
        split = min(s.trained_blocks)
        teacher = {**self.p, **self.teacher}
        with torch.no_grad():
            x = vit.embed(self.p, clips.reshape(B * T, H, W, 3), s.vit, BB)
            trunk = vit.blocks(self.p, x, s.vit, 0, split, BB, self.quant)
            trunk = trunk.reshape(B, T, *trunk.shape[1:])
            feats = self._tail(self.p, trunk.flatten(0, 1), False)
            feats = feats.reshape(B, T, *feats.shape[1:])
            src = self._tail(teacher, trunk[:, 0], True)
            N = src.shape[1]
            q = sinkhorn(self._similarity(src.reshape(B * N, -1), teacher["prototypes"]),
                         s.epsilon, s.sinkhorn_iters).reshape(B, N, -1)
            prop = propagate(feats, q.transpose(1, 2), s.n_last, s.radius, s.topk)
            labels = prop[:, -1].argmax(dim=1)
        leaves = {k: self.p[k].clone().requires_grad_(True) for k in self.names}
        params = {**self.p, **leaves}
        out = self._tail(params, trunk[:, -1], True)
        logits = self._similarity(out, params["prototypes"]) / s.temperature
        loss = F.cross_entropy(logits.flatten(0, 1), labels.flatten())
        grads = dict(zip(self.names, torch.autograd.grad(loss, [leaves[k] for k in self.names],
                                                          allow_unused=True)))
        grads = {k: torch.zeros_like(self.p[k]) if g is None else g for k, g in grads.items()}
        if self.first_grads is None:
            self.first_grads = {k: g.detach().clone() for k, g in grads.items()}
        self._update(grads)
        return float(loss.detach())

    @torch.no_grad()
    def _update(self, grads: dict) -> None:
        s = self.s
        total = s.num_epochs * s.steps_per_epoch
        t = self.count + 1
        lr = s.lr * 0.5 * (1.0 + math.cos(math.pi * min(self.count, total) / total))
        wd = _cosine(0.04, 0.4, total, self.count)
        for k in self.names:
            p, g = self.p[k], grads[k]
            plr = lr if not k.startswith(BB) else lr / 10.0
            if decays(k, p.shape):
                p.mul_(1.0 - plr * wd)
            self.m[k].lerp_(g, 1.0 - _B1)
            self.v[k].mul_(_B2).addcmul_(g, g, value=1.0 - _B2)
            den = self.v[k].sqrt() / math.sqrt(1.0 - _B2 ** t) + _EPS
            p.add_(self.m[k] / den, alpha=-plr / (1.0 - _B1 ** t))
        pr = self.p["prototypes"]
        pr.copy_(pr / (torch.linalg.vector_norm(pr, dim=-1, keepdim=True) + 1e-12))
        mom = _cosine(0.995, 1.0, total, self.count)
        for k in self.names:
            self.teacher[k].mul_(1.0 - mom).add_(self.p[k], alpha=mom)
        tp = self.teacher["prototypes"]
        tp.copy_(tp / (torch.linalg.vector_norm(tp, dim=-1, keepdim=True) + 1e-12))
        self.count += 1
