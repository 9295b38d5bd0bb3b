"""The plain reference of the image encoder of Segment Anything, ViT-H
(``build_sam_vit_h``).

Plain PyTorch in float32, from the published description (Kirillov et al.
2023, arXiv:2304.02643; ``facebookresearch/segment-anything``,
``segment_anything/build_sam.py``, ``modeling/image_encoder.py``):

* a 16 x 16 patch convolution with bias to D; no CLS token; a learned
  ``pos_embed`` [1, G, G, D] (G = input / 16) added as it is, never resized;
* pre-norm blocks, LayerNorm eps 1e-6, ``x = x + proj(attn(LN1(x)))``, ``x =
  x + lin2(gelu(lin1(LN2(x))))`` (exact erf GELU), qkv with a bias;
* the blocks of ``global_blocks`` attend over the whole G x G grid; the
  others within ``window`` x ``window`` windows: LN1's output is padded at
  the bottom and right with zero rows to a multiple of the window, cut into
  windows, attended within each (the padded positions take part as keys:
  nothing is masked), merged back, cropped, and added to the residual;
* in every block the decomposed relative-position bias of the scores:
  ``(q scale) k^T + q . Rh[qh - kh + K - 1] + q . Rw[qw - kw + K - 1]`` with
  the unscaled q, ``Rh``, ``Rw`` the block's ``rel_pos_h``, ``rel_pos_w``
  [2 K - 1, Dh] and K the window's side (windowed) or G (global);
* the neck: a 1 x 1 convolution D -> 256 without bias, LayerNorm2d, a 3 x 3
  convolution 256 -> 256 (padding 1, no bias), LayerNorm2d (eps 1e-6 over
  the channels); the image embedding [B, 256, G, G], whose G x G tokens in
  raster order are the dense features.

Departures, each a consequence of the runs: a global block's attention is
computed a frame and ``head_group`` heads at a time (the same arithmetic as
one softmax over the frame's tokens: 4,096 tokens x 16 heads would hold 1
GB a frame).

Parameters are a flat dict in the release checkpoint's layout
(``image_encoder.patch_embed.proj``, ``image_encoder.pos_embed``,
``image_encoder.blocks.i.{norm1, attn.qkv, attn.proj, attn.rel_pos_h,
attn.rel_pos_w, norm2, mlp.lin1, mlp.lin2}``, ``image_encoder.neck.0``-``3``),
so one state dict serves the reference and the program.

``quant="fp8"``: both operands of every matrix product in float8 e4m3 with
a per-tensor scale (``vit.fp8``; the bias tables' products too), the
control. ``fault``: ``no_relpos`` (no position bias), ``all_global`` (no
windows: every block global, a window's tables resized linearly to the
grid's offsets as SAM's ``get_rel_pos`` resizes a table of another size),
``pad_masked`` (the padded keys left out of each window's softmax),
``relpos_swapped`` (``Rh`` and ``Rw`` exchanged) and ``pad_before_norm``
(the grid padded before LN1, so the padded rows read LN1's bias): what a
program with such a fault would give.

Imports nothing of the program, of JAX, or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from benchmark.reference.dense import preprocess
from benchmark.reference.vit import _mm_operands, linear

LN_EPS = 1e-6
PREFIX = "image_encoder."
# the spread of the relative-position tables: rel_h + rel_w over a
# unit-variance q of 80 features then spreads as (q scale) k^T does, whose
# spread over unit-variance q and k is 1 (1 / sqrt(2 x 80))
REL_POS_STD = 0.08
FAULTS = ("no_relpos", "all_global", "pad_masked", "relpos_swapped", "pad_before_norm")


@dataclasses.dataclass(frozen=True)
class SamShape:
    patch: int = 16
    dim: int = 1280
    depth: int = 32
    heads: int = 16
    hidden: int = 5120
    window: int = 14
    global_blocks: tuple = (7, 15, 23, 31)
    img_size: int = 1024
    out_chans: int = 256

    @classmethod
    def of(cls, config: dict) -> "SamShape":
        return cls(patch=config["patch_size"], dim=config["embed_dim"],
                   depth=config["depth"], heads=config["num_heads"],
                   hidden=config["mlp_hidden"], window=config["window_size"],
                   global_blocks=tuple(config["global_attn_indexes"]),
                   img_size=config["input_size"], out_chans=config["out_chans"])

    @property
    def grid(self) -> int:
        return self.img_size // self.patch

    def side(self, i: int) -> int:
        """The side of block ``i``'s attention grid: the window's, or the
        whole grid's for a global block."""
        return self.grid if i in self.global_blocks else self.window


def param_shapes(s: SamShape) -> dict:
    """Every parameter's shape, in the release checkpoint's layout."""
    D, H, G, Dh = s.dim, s.hidden, s.grid, s.dim // s.heads
    p = PREFIX
    out = {p + "pos_embed": (1, G, G, D),
           p + "patch_embed.proj.weight": (D, 3, s.patch, s.patch),
           p + "patch_embed.proj.bias": (D,)}
    for i in range(s.depth):
        b = f"{p}blocks.{i}."
        K = s.side(i)
        out.update({b + "norm1.weight": (D,), b + "norm1.bias": (D,),
                    b + "attn.qkv.weight": (3 * D, D), b + "attn.qkv.bias": (3 * D,),
                    b + "attn.proj.weight": (D, D), b + "attn.proj.bias": (D,),
                    b + "attn.rel_pos_h": (2 * K - 1, Dh), b + "attn.rel_pos_w": (2 * K - 1, Dh),
                    b + "norm2.weight": (D,), b + "norm2.bias": (D,),
                    b + "mlp.lin1.weight": (H, D), b + "mlp.lin1.bias": (H,),
                    b + "mlp.lin2.weight": (D, H), b + "mlp.lin2.bias": (D,)})
    out.update({p + "neck.0.weight": (s.out_chans, D, 1, 1),
                p + "neck.1.weight": (s.out_chans,), p + "neck.1.bias": (s.out_chans,),
                p + "neck.2.weight": (s.out_chans, s.out_chans, 3, 3),
                p + "neck.3.weight": (s.out_chans,), p + "neck.3.bias": (s.out_chans,)})
    return out


def seeded_weights(s: SamShape, seed: int, device) -> dict:
    """Weights of the given shape from ``seed``, made on ``device`` in one
    normal draw: matrices and convolutions at std 1 / sqrt(fan in) truncated
    at 2 std, biases (the qkv bias among them) at std 0.02, LayerNorm and
    LayerNorm2d scales 1 + 0.1 N(0, 1), ``pos_embed`` at std 0.02 truncated
    at 2 std, the relative-position tables at ``REL_POS_STD``. In f32."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    shapes = param_shapes(s)
    sizes = {k: math.prod(v) for k, v in shapes.items()}
    flat = torch.randn(sum(sizes.values()), generator=gen, device=device)
    out, at = {}, 0
    for k, shape in shapes.items():
        v = flat[at:at + sizes[k]].view(shape)
        at += sizes[k]
        if k.endswith("rel_pos_h") or k.endswith("rel_pos_w"):
            v = REL_POS_STD * v
        elif k.endswith("weight") and len(shape) > 1:
            v = v.clamp(-2.0, 2.0) * math.prod(shape[1:]) ** -0.5
        elif k.endswith("weight"):
            v = 1.0 + 0.1 * v
        elif k.endswith("bias"):
            v = 0.02 * v
        else:
            v = 0.02 * v.clamp(-2.0, 2.0)
        out[k] = v.contiguous()
    return out


def layer_norm(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps=LN_EPS)


def layer_norm_2d(x, w, b):
    """SAM's ``LayerNorm2d``: over the channels of [B, C, H, W]."""
    u = x.mean(1, keepdim=True)
    v = (x - u).pow(2).mean(1, keepdim=True)
    return w[:, None, None] * ((x - u) / torch.sqrt(v + LN_EPS)) + b[:, None, None]


def window_partition(x: torch.Tensor, win: int):
    """[B, H, W, C] -> windows [B nh nw, win, win, C] of the grid padded with
    zeros at the bottom and right, and the padded size."""
    B, H, W, C = x.shape
    ph, pw = (win - H % win) % win, (win - W % win) % win
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.view(B, Hp // win, win, Wp // win, win, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win, win, C), (Hp, Wp)


def window_unpartition(w: torch.Tensor, win: int, padded, hw) -> torch.Tensor:
    Hp, Wp = padded
    H, W = hw
    B = w.shape[0] // (Hp // win * Wp // win)
    x = w.view(B, Hp // win, Wp // win, win, win, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W]


def rel_table(rel: torch.Tensor, K: int) -> torch.Tensor:
    """``get_rel_pos`` at equal query and key sides K: [K, K, Dh], entry
    (a, b) the table's row a - b + K - 1."""
    idx = torch.arange(K, device=rel.device)[:, None] - torch.arange(K, device=rel.device)[None, :]
    return rel[idx + K - 1]


def attention(p: dict, x: torch.Tensor, k: str, heads: int, quant=None, fault=None,
              key_ok=None, head_group: int = 4) -> torch.Tensor:
    """SAM's ``Attention`` over sequences x [N, K, K, D] (a K x K grid each):
    the scores' decomposed relative-position bias from the unscaled q;
    ``key_ok`` [K * K] (bool) leaves keys out of the softmax. Returns the
    projected [N, K, K, D]."""
    N, K, _, D = x.shape
    Dh = D // heads
    qkv = linear(x, p[k + "attn.qkv.weight"], p[k + "attn.qkv.bias"], quant)
    qkv = qkv.reshape(N, K * K, 3, heads, Dh).permute(2, 0, 3, 1, 4)
    q, kk, v = qkv[0], qkv[1], qkv[2]
    rh, rw = p[k + "attn.rel_pos_h"], p[k + "attn.rel_pos_w"]
    if fault == "relpos_swapped":
        rh, rw = rw, rh
    if rh.shape[0] != 2 * K - 1:
        # the all_global fault: a window's tables at the grid's offsets,
        # resized linearly as SAM's ``get_rel_pos`` resizes a table of
        # another size
        rh, rw = (F.interpolate(t.t()[None], size=2 * K - 1, mode="linear")[0].t()
                  for t in (rh, rw))
    Rh, Rw = rel_table(rh, K), rel_table(rw, K)
    o = torch.empty_like(q)
    for h0 in range(0, heads, head_group):
        hs = slice(h0, h0 + head_group)
        qh, kh = _mm_operands(q[:, hs], kk[:, hs], quant)
        att = (qh * Dh ** -0.5) @ kh.transpose(-2, -1)
        if fault != "no_relpos":
            rq = q[:, hs].reshape(N, -1, K, K, Dh)
            rq_h, rh_ = _mm_operands(rq, Rh, quant)
            rq_w, rw_ = _mm_operands(rq, Rw, quant)
            rel_h = torch.einsum("nhyxc,ykc->nhyxk", rq_h, rh_)
            rel_w = torch.einsum("nhyxc,xkc->nhyxk", rq_w, rw_)
            att = (att.view(N, -1, K, K, K, K) + rel_h[..., :, None]
                   + rel_w[..., None, :]).view(att.shape)
        if key_ok is not None:
            att = att.masked_fill(~key_ok, float("-inf"))
        att = torch.softmax(att, dim=-1)
        att, vh = _mm_operands(att, v[:, hs], quant)
        o[:, hs] = att @ vh
    o = o.transpose(1, 2).reshape(N, K, K, D)
    return linear(o, p[k + "attn.proj.weight"], p[k + "attn.proj.bias"], quant)


def block(p: dict, x: torch.Tensor, i: int, s: SamShape, quant=None,
          fault=None) -> torch.Tensor:
    """Block ``i`` over x [B, G, G, D]."""
    k = f"{PREFIX}blocks.{i}."
    B, G, _, D = x.shape
    windowed = i not in s.global_blocks and fault != "all_global"
    n1w, n1b = p[k + "norm1.weight"], p[k + "norm1.bias"]
    if not windowed:
        h = torch.cat([attention(p, layer_norm(x[b:b + 1], n1w, n1b), k, s.heads, quant, fault)
                       for b in range(B)])
    else:
        win = s.window
        if fault == "pad_before_norm":
            w, padded = window_partition(x, win)
            w = layer_norm(w, n1w, n1b)
        else:
            w, padded = window_partition(layer_norm(x, n1w, n1b), win)
        key_ok = None
        if fault == "pad_masked":
            Hp = padded[0]
            pos = torch.arange(Hp, device=x.device).view(Hp // win, win)
            real = pos < G
            key_ok = (real[:, :, None, None] & real[None, None, :, :])   # [nh, win, nw, win]
            key_ok = key_ok.permute(0, 2, 1, 3).reshape(-1, win * win)  # a window's keys
            key_ok = key_ok.repeat(B, 1)[:, None, None, :]
        h = attention(p, w, k, s.heads, quant, fault, key_ok)
        h = window_unpartition(h, win, padded, (G, G))
    x = x + h
    h = F.gelu(linear(layer_norm(x, p[k + "norm2.weight"], p[k + "norm2.bias"]),
                      p[k + "mlp.lin1.weight"], p[k + "mlp.lin1.bias"], quant))
    return x + linear(h, p[k + "mlp.lin2.weight"], p[k + "mlp.lin2.bias"], quant)


def conv(x, w, quant, padding=0):
    x, w = _mm_operands(x, w, quant)
    return F.conv2d(x, w, padding=padding)


def embedding(p: dict, x: torch.Tensor, s: SamShape, quant=None, fault=None) -> torch.Tensor:
    """The image embedding [B, 256, G, G] of images x [B, H, W, 3]."""
    if x.shape[1:3] != (s.img_size, s.img_size):
        raise ValueError(f"sam: the encoder takes {s.img_size} x {s.img_size} images, got "
                         f"{tuple(x.shape[1:3])}")
    t = F.conv2d(x.permute(0, 3, 1, 2), p[PREFIX + "patch_embed.proj.weight"],
                 p[PREFIX + "patch_embed.proj.bias"], stride=s.patch)
    t = t.permute(0, 2, 3, 1) + p[PREFIX + "pos_embed"]
    for i in range(s.depth):
        t = block(p, t, i, s, quant, fault)
    n = PREFIX + "neck."
    t = conv(t.permute(0, 3, 1, 2), p[n + "0.weight"], quant)
    t = layer_norm_2d(t, p[n + "1.weight"], p[n + "1.bias"])
    t = conv(t, p[n + "2.weight"], quant, padding=1)
    return layer_norm_2d(t, p[n + "3.weight"], p[n + "3.bias"])


def features(p: dict, x: torch.Tensor, s: SamShape, quant=None, fault=None) -> torch.Tensor:
    """The dense features [B, G * G, 256]: the embedding's tokens in raster
    order."""
    return embedding(p, x, s, quant, fault).flatten(2).transpose(1, 2)


@torch.no_grad()
def features_u8(p: dict, frames_u8: torch.Tensor, s: SamShape, mean, std, quant=None,
                fault=None, chunk: int = 2) -> torch.Tensor:
    """The features [N, G * G, 256] of uint8 frames [N, H, W, 3] through the
    eval preprocess (``dense.preprocess`` at the encoder's input), ``chunk``
    frames at a time, with TF32 off for matrix products and convolutions."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = [features(p, preprocess(frames_u8[i:i + chunk], s.img_size, mean, std), s,
                        quant, fault)
               for i in range(0, frames_u8.shape[0], chunk)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return torch.cat(out)
