"""Slot attention and the motion-grouping autoencoder baseline, on PyTorch.

Counterpart of ``timetuning_tpu/models/slot_attention.py`` (reference
models.py:1219-1289 ``SlotAttention``; motion_grouping_model.py:18-250
``SoftPositionEmbed`` and ``SlotAttentionAutoEncoder`` with its CNN encoder
and spatial-broadcast decoder), read by the zoo as
``get_backbone("motion_grouping")`` (models.py:876-884). Input NHWC. Module
and parameter names follow the Flax tree (``gru.ir`` ... , ``conv{i}``,
``in{i}``, ``dec{i}``), so ``models/convert`` carries it across by name. The
slots' initial noise is an argument, or drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from timetuning_tpu_torch.ops.resize import resize_bilinear

_LN_EPS = 1e-6     # flax's LayerNorm


class GRUCell(nn.Module):
    """Flax's ``GRUCell``: r, z = sigmoid(W_i{r,z} x + b + W_h{r,z} h),
    n = tanh(W_in x + b + r (W_hn h + b)), h' = (1 - z) n + z h."""

    def __init__(self, dim: int):
        super().__init__()
        self.ir, self.iz, self.in_ = (nn.Linear(dim, dim) for _ in range(3))
        self.hr = nn.Linear(dim, dim, bias=False)
        self.hz = nn.Linear(dim, dim, bias=False)
        self.hn = nn.Linear(dim, dim)

    def forward(self, h, x):
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(self.in_(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class SlotAttention(nn.Module):
    def __init__(self, num_slots: int = 5, dim: int = 64, iters: int = 3,
                 hidden_dim: int = 128, eps: float = 1e-8):
        super().__init__()
        self.num_slots, self.dim, self.iters, self.eps = num_slots, dim, iters, eps
        self.slots_mu = nn.Parameter(torch.zeros(1, 1, dim))
        self.slots_logsigma = nn.Parameter(torch.zeros(1, 1, dim))
        self.norm_input = nn.LayerNorm(dim, eps=_LN_EPS)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.norm_slots = nn.LayerNorm(dim, eps=_LN_EPS)
        self.norm_pre_ff = nn.LayerNorm(dim, eps=_LN_EPS)
        self.gru = GRUCell(dim)
        self.mlp1 = nn.Linear(dim, hidden_dim)
        self.mlp2 = nn.Linear(hidden_dim, dim)

    def forward(self, inputs, noise=None, generator=None, num_slots: int | None = None):
        """inputs [B, N, dim]; ``noise`` [B, K, dim] standard normal (drawn
        from ``generator`` when not given). -> (slots [B, K, dim], the last
        iteration's attention [B, K, N])."""
        B, N, _ = inputs.shape
        K = num_slots or self.num_slots
        if noise is None:
            noise = torch.randn((B, K, self.dim), generator=generator).to(inputs.device)
        slots = self.slots_mu + torch.exp(self.slots_logsigma) * noise
        inputs = self.norm_input(inputs)
        k, v = self.to_k(inputs), self.to_v(inputs)
        scale = self.dim ** -0.5
        attn = None
        for _ in range(self.iters):
            prev = slots
            q = self.to_q(self.norm_slots(slots))
            attn = torch.softmax(torch.einsum("bkd,bnd->bkn", q, k) * scale,
                                 dim=1) + self.eps
            attn = attn / attn.sum(dim=-1, keepdim=True)
            updates = torch.einsum("bkn,bnd->bkd", attn, v)
            slots = self.gru(prev.reshape(-1, self.dim),
                             updates.reshape(-1, self.dim)).reshape(B, K, self.dim)
            slots = slots + self.mlp2(F.relu(self.mlp1(self.norm_pre_ff(slots))))
        return slots, attn


class SoftPositionEmbed(nn.Module):
    """x [..., H, W, C] + Dense(4 -> C) of the (y, x, 1 - y, 1 - x) grid."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.proj = nn.Linear(4, hidden_size)

    def forward(self, x):
        H, W = x.shape[-3:-1]
        ys = torch.linspace(0.0, 1.0, H, device=x.device)
        xs = torch.linspace(0.0, 1.0, W, device=x.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        grid = torch.stack([gy, gx, 1 - gy, 1 - gx], dim=-1)
        return x + self.proj(grid)


class EncoderCNN(nn.Module):
    """The reference encoder CNN (motion_grouping_model.py:160-218,
    ``encoder_arch=[64, 'MP', 128, 'MP', 256]``): per stage two 5 x 5
    convolutions, each followed by affine InstanceNorm (eps 1e-5) and ReLU,
    a ceil-mode 2 x 2 max-pool between stages; output stride 4, 256
    channels. NHWC in and out."""

    def __init__(self, arch: tuple = (64, "MP", 128, "MP", 256)):
        super().__init__()
        self.arch = arch
        cin, i = 3, 0
        for v in arch:
            if v == "MP":
                continue
            for _ in range(2):
                setattr(self, f"conv{i}", nn.Conv2d(cin, v, 5, padding=2))
                setattr(self, f"in{i}", nn.GroupNorm(v, v, eps=1e-5))
                cin, i = v, i + 1
        self.out_dim = int(arch[-1])

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).float()
        i = 0
        for v in self.arch:
            if v == "MP":
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
                continue
            for _ in range(2):
                x = getattr(self, f"conv{i}")(x)
                x = F.relu(getattr(self, f"in{i}")(x))
                i += 1
        return x.permute(0, 2, 3, 1)


def motion_grouping_encoder_from_torch(sd, prefix: str = "encoder.") -> dict[str, torch.Tensor]:
    """A motion-grouping checkpoint's ``encoder_cnn.*`` Sequential keys (the
    reference loads ``checkpoint['model_state_dict']``, models.py:876-884)
    as ``EncoderCNN``'s state dict under ``prefix``: convolutions and
    InstanceNorms at the Sequential's fixed indices for
    ``[64, 'MP', 128, 'MP', 256]`` (timetuning_tpu/models/slot_attention.py:120)."""
    conv_idx = (0, 3, 7, 10, 14, 17)
    in_idx = (1, 4, 8, 11, 15, 18)
    out = {}
    for j, (ci, ni) in enumerate(zip(conv_idx, in_idx)):
        for src, dst in ((ci, f"conv{j}"), (ni, f"in{j}")):
            for p in ("weight", "bias"):
                out[f"{prefix}{dst}.{p}"] = torch.as_tensor(
                    np.asarray(sd[f"encoder_cnn.{src}.{p}"])).float()
    return out


def conv_transpose_same(x, conv: nn.Conv2d, stride: int):
    """Flax's ``ConvTranspose`` (padding SAME, kernel not flipped): ``x``
    NCHW dilated by ``stride``, padded as ``lax.conv_transpose`` pads SAME,
    then correlated with the kernel. ``conv`` holds the kernel as [O, I, k, k]."""
    k = conv.weight.shape[-1]
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
    pad_b = pad_len - pad_a
    B, C, H, W = x.shape
    d = x.new_zeros(B, C, (H - 1) * stride + 1, (W - 1) * stride + 1)
    d[:, :, ::stride, ::stride] = x
    d = F.pad(d, (pad_a, pad_b, pad_a, pad_b))
    return F.conv2d(d, conv.weight, conv.bias)


class SlotAttentionAutoEncoder(nn.Module):
    """The object-discovery autoencoder (reference
    motion_grouping_model.py:144-250): encoder, position embedding, slot
    attention, a spatial-broadcast decoder at 1/16 of the resolution
    upsampled by four stride-2 transposed convolutions. ``forward(x NHWC)``
    -> (combined, recon, masks, slots)."""

    def __init__(self, resolution: tuple = (128, 128), num_slots: int = 5,
                 iters: int = 3, hidden_dim: int = 64):
        super().__init__()
        self.resolution, self.num_slots, self.hidden_dim = resolution, num_slots, hidden_dim
        self.encoder = EncoderCNN()
        c = self.encoder.out_dim
        self.enc_pos = SoftPositionEmbed(c)
        self.enc_norm = nn.LayerNorm(c, eps=_LN_EPS)
        self.enc_fc1 = nn.Linear(c, hidden_dim)
        self.enc_fc2 = nn.Linear(hidden_dim, hidden_dim)
        self.slot_attention = SlotAttention(num_slots, hidden_dim, iters)
        self.dec_pos = SoftPositionEmbed(hidden_dim)
        for i in range(4):
            setattr(self, f"dec{i}", nn.Conv2d(hidden_dim, hidden_dim, 5))
        self.dec_out = nn.Conv2d(hidden_dim, 4, 3, padding=1)

    def forward(self, x, noise=None, generator=None):
        B = x.shape[0]
        h = self.enc_pos(self.encoder(x))
        H, W = h.shape[1:3]
        t = self.enc_norm(h.reshape(B, H * W, -1))
        t = self.enc_fc2(F.relu(self.enc_fc1(t)))
        slots, _ = self.slot_attention(t, noise=noise, generator=generator)
        r0, r1 = self.resolution[0] // 16, self.resolution[1] // 16
        K, D = self.num_slots, self.hidden_dim
        d = slots.reshape(B * K, 1, 1, D).expand(B * K, r0, r1, D)
        d = self.dec_pos(d).permute(0, 3, 1, 2)
        for i in range(4):
            d = F.relu(conv_transpose_same(d, getattr(self, f"dec{i}"), 2))
        d = self.dec_out(d).permute(0, 2, 3, 1)
        d = d.reshape(B, K, *d.shape[1:])
        recon, masks = d[..., :3], torch.softmax(d[..., 3:], dim=1)
        return (recon * masks).sum(dim=1), recon, masks, slots


class MotionGroupingBackbone(nn.Module):
    """The zoo's adapter (reference models.py:1055-1061): the autoencoder's
    encoder CNN, bilinearly resized to the fixed ``grid`` x ``grid`` (the
    values of ``jax.image.resize``) and flattened to tokens. The encoder is
    named as inside the autoencoder, so a trained autoencoder's
    ``encoder.*`` weights load as they are."""

    def __init__(self, grid: int = 56):
        super().__init__()
        self.encoder = EncoderCNN()
        self.grid = grid

    def forward(self, x, want_attention: bool = False):
        del want_attention
        h = self.encoder(x).permute(0, 3, 1, 2)
        h = resize_bilinear(h, (self.grid, self.grid))
        return {"tokens": h.flatten(2).transpose(1, 2), "attention": None,
                "grid": (self.grid, self.grid)}
