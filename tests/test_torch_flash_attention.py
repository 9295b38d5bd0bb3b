"""The port's flash attention (timetuning_tpu_torch/ops/flash_attention.py)
and attention dispatcher (ops/attention.py) against the JAX package's: the
plain version against JAX ``flash_attention_xla`` and against both TPU
kernels in interpret mode, on the same numpy-seeded inputs; the dispatcher's
route against JAX's ``attention`` with a TPU backend stood in."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetuning_tpu.ops import attention as jattn
from timetuning_tpu.ops import flash_attention as jfa
from timetuning_tpu_torch.ops import attention as tattn
from timetuning_tpu_torch.ops import flash_attention as tfa
from timetuning_tpu_torch.ops import kernel_lib

torch.set_num_threads(2)

# (Sq, Sk, kv_len): square, ragged, queries != keys, masked key tail
CASES = [(130, 130, None), (300, 300, None), (130, 300, None), (300, 130, 97),
         (130, 300, 211)]


def _qkv(Sq, Sk, seed, B=1, H=2, Dh=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, Dh)).astype(np.float32),
            rng.standard_normal((B, H, Sk, Dh)).astype(np.float32),
            rng.standard_normal((B, H, Sk, Dh)).astype(np.float32))


def _bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits), taken at
    1/16 for outputs below it: near zero the difference is set by p, not by
    the output's own rounding (one p of ~1/S rounding the other way moves
    the output by ~|v| * 2^-15)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -4))) - 7)


@pytest.mark.parametrize("Sq,Sk,kv_len", CASES)
def test_plain_matches_jax_flash_attention_xla(Sq, Sk, kv_len):
    """f32 at 1e-5; bf16 within one bf16 ulp (the same operations, only the
    f32 summation order differs)."""
    arrs = _qkv(Sq, Sk, seed=Sq + Sk)
    want = jfa.flash_attention_xla(*(jnp.asarray(a) for a in arrs), kv_len=kv_len)
    got = tfa.flash_attention_xla(*(torch.from_numpy(a) for a in arrs), kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    want = np.asarray(jfa.flash_attention_xla(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrs), kv_len=kv_len), np.float32)
    got = tfa.flash_attention_xla(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in arrs), kv_len=kv_len)
    assert got.dtype == torch.bfloat16
    assert (np.abs(got.float().numpy() - want) <= _bf16_ulp(want)).all()


@pytest.mark.parametrize("kernel", ["resident", "streamed"])
@pytest.mark.parametrize("Sq,Sk,kv_len", CASES)
def test_wrapper_matches_tpu_kernels_interpret(kernel, Sq, Sk, kv_len):
    """The CPU path of the kernel wrapper against the TPU kernels: the
    single-pass one (one key tile) and the streamed one (128-key tiles,
    several online-softmax steps). f32 at 1e-5; bf16 at 2e-2, because p
    rounds to bf16 against the running max in the kernels and against the
    row max in the plain softmax."""
    arrs = _qkv(Sq, Sk, seed=Sq * Sk)
    fn = (jfa.flash_attention_fwd_pallas if kernel == "resident" else
          lambda *a, **kw: jfa.flash_attention_fwd_pallas_streamed(
              *a, block_q=128, block_k=128, **kw))
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-5),
                          (jnp.bfloat16, torch.bfloat16, 2e-2)):
        want = fn(*(jnp.asarray(a, jdt) for a in arrs), kv_len=kv_len,
                  interpret=True)
        got = tfa.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrs),
                                  kv_len=kv_len)
        assert got.dtype == tdt and got.shape == (1, 2, Sq, 64)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("Sq,Sk,kv_len", [(1, 40, None), (129, 300, 1),
                                          (127, 256, 128), (127, 256, 129)])
def test_wrapper_matches_tpu_kernel_at_block_and_tile_edges(Sq, Sk, kv_len):
    """The edges that the CUDA kernel's tiling adds (one query, one valid
    key, 127 and 129 rows around its 128-row block, a mask on and one past
    its 128-key tile edge): the wrapper's CPU path against the single-pass
    TPU kernel in interpret mode, tolerances as above."""
    arrs = _qkv(Sq, Sk, seed=Sq + 7 * Sk)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-5),
                          (jnp.bfloat16, torch.bfloat16, 2e-2)):
        want = jfa.flash_attention_fwd_pallas(*(jnp.asarray(a, jdt) for a in arrs),
                                              kv_len=kv_len, interpret=True)
        got = tfa.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrs),
                                  kv_len=kv_len)
        assert got.dtype == tdt and got.shape == (1, 2, Sq, 64)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("Sq,Sk,kv_len", [(1025, 1025, 1000), (130, 300, 211)])
def test_wrapper_matches_tpu_kernel_at_32_wide_heads(Sq, Sk, kv_len):
    """MoCo-v3 ViT-S/16's heads of 32 (the TPU kernel pads any Dh to 128
    lanes): the wrapper's CPU path against the single-pass TPU kernel in
    interpret mode, past 1,024 keys with a key mask, tolerances as above;
    its output in the kernel's layout (a view of [B, Sq, H, Dh])."""
    arrs = _qkv(Sq, Sk, seed=Sq + 32, Dh=32)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-5),
                          (jnp.bfloat16, torch.bfloat16, 2e-2)):
        want = jfa.flash_attention_fwd_pallas(*(jnp.asarray(a, jdt) for a in arrs),
                                              kv_len=kv_len, interpret=True)
        got = tfa.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrs),
                                  kv_len=kv_len)
        assert got.dtype == tdt and got.shape == (1, 2, Sq, 32)
        assert got.permute(0, 2, 1, 3).is_contiguous()
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """A non-CPU tensor never reaches the plain version: a head width other
    than 32 or 64, or mixed dtypes, raise before any launch (meta tensors
    stand in for a device here); heads of 32 pass to the device check."""
    q = torch.zeros(1, 2, 8, 48, device="meta")
    with pytest.raises(ValueError, match="32- or 64-wide"):
        tfa.flash_attention(q, q, q)
    for dt in (torch.float32, torch.bfloat16):
        q = torch.zeros(1, 2, 8, 32, device="meta", dtype=dt)
        with pytest.raises(ValueError, match="expected CUDA tensors"):
            tfa.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="bf16 or all f32"):
        tfa.flash_attention(q, q, q.half())
    with pytest.raises(ValueError, match="kv_len"):
        tfa.flash_attention(q, q, q, kv_len=9)


@pytest.mark.parametrize("B,H,Sk,kv_len,overlapped,tiles", [
    (25, 6, 3137, None, 24, 25),      # S/8 at 448, the serving request
    (25, 24, 1029, None, 8, 9),       # DINOv2 ViT-g at 448 (a last tile of 5 keys)
    (2, 3, 128, None, 0, 1),          # one key tile: nothing overlaps
    (2, 3, 40, None, 0, 1),
    (2, 3, 256, None, 1, 2),          # two tiles: the prologue and the epilogue
    (1, 2, 3138, 3137, 24, 25),       # sp's launch: keys past kv_len are not walked
    (4, 6, 1100, 129, 1, 2),
])
@pytest.mark.parametrize("Dh", [64, 32])
def test_a_launch_counts_its_key_tiles_from_its_shape(monkeypatch, B, H, Sk, kv_len,
                                                      overlapped, tiles, Dh):
    """The bf16 core's work counts beside its launch count: every key tile of
    each (batch, head), and those whose softmax runs under the p @ v of the
    tile before ((n - 1) / n of them: 24/25 at 3,137 keys, 8/9 at 1,029,
    none in one tile); f32 and heads of 128 raise neither. The launch itself
    is stood in for (meta tensors)."""
    launched = []
    monkeypatch.setattr(kernel_lib, "require_cuda", lambda *a: None)
    monkeypatch.setattr(kernel_lib, "launch", lambda kernel, fn, *a: launched.append(kernel))
    assert tfa.key_tile_counts(B, H, Sk if kv_len is None else kv_len) == (
        B * H * overlapped, B * H * tiles)
    kernel_lib.reset_launch_counts()
    q = torch.zeros(B, H, 100, Dh, device="meta", dtype=torch.bfloat16)
    k = torch.zeros(B, H, Sk, Dh, device="meta", dtype=torch.bfloat16)
    tfa.flash_attention(q, k, k, kv_len=kv_len)
    assert launched == ["flash_attention"]
    assert kernel_lib.WORK_COUNTS == {"flash_key_tiles": B * H * tiles,
                                      "flash_key_tiles_overlapped": B * H * overlapped,
                                      "relpos_windows": 0, "relpos_global": 0,
                                      "relpos_windows_resident": 0, "window_pad_rows": 0}
    tfa.flash_attention(q.float(), k.float(), k.float(), kv_len=kv_len)
    wide = torch.zeros(B, H, Sk, 128, device="meta", dtype=torch.bfloat16)
    tfa.flash_attention(wide[:, :, :100], wide, wide, kv_len=kv_len)
    assert launched == ["flash_attention", "flash_attention", "flash_d128"]
    assert kernel_lib.counts()["flash_key_tiles"] == B * H * tiles
    kernel_lib.reset_launch_counts()
    assert not any(kernel_lib.counts().values())


def test_counts_are_raised_by_name_as_a_graph_replay_raises_them():
    """``counts`` holds the launch and the work counts under one set of names
    and ``add_counts`` raises either by name: what ``CapturedCall`` takes out
    of a capture and adds on a replay."""
    kernel_lib.reset_launch_counts()
    kernel_lib.add_counts({"flash_attention": 12, "flash_key_tiles": 300,
                           "flash_key_tiles_overlapped": 288})
    kernel_lib.add_counts({"flash_attention": 12, "flash_key_tiles": 300})
    got = {k: v for k, v in kernel_lib.counts().items() if v}
    assert got == {"flash_attention": 24, "flash_key_tiles": 600,
                   "flash_key_tiles_overlapped": 288}
    kernel_lib.reset_launch_counts()


def _jax_route(monkeypatch, dtype, S, return_probs):
    """The route JAX's ``attention`` takes with ``impl="auto"`` on a TPU
    backend: its three targets replaced by markers."""
    monkeypatch.setattr(jattn.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jattn, "_attention_fused", lambda q, k, v: "mha")
    monkeypatch.setattr(jattn, "attention_xla",
                        lambda q, k, v, return_probs=False: ("plain", None))
    monkeypatch.setattr(jfa, "flash_attention", lambda q, k, v: "flash")
    q = jnp.zeros((1, 1, S, 8), dtype)
    out = jattn.attention(q, q, q, return_probs=return_probs, impl="auto")
    return out[0]


@pytest.mark.parametrize("return_probs", [False, True])
@pytest.mark.parametrize("S", [197, 1024, 1025])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dispatcher_route_matches_jax(monkeypatch, return_probs, S, dtype):
    """The decision table (ops/attention.py:186-198, impl="auto"): on a CUDA
    tensor the port routes where JAX routes on its TPU; on a CPU tensor it
    takes the plain version, as JAX off the TPU."""
    tdt = getattr(torch, dtype)
    want = _jax_route(monkeypatch, getattr(jnp, dtype), S, return_probs)
    assert tattn.attention_route(tdt, S, return_probs, on_cuda=True) == want
    assert tattn.attention_route(tdt, S, return_probs, on_cuda=False) == "plain"


def test_dispatcher_runs_plain_on_cpu():
    arrs = [torch.from_numpy(a) for a in _qkv(1100, 1100, seed=5, H=1, Dh=8)]
    out, probs = tattn.attention(*arrs)
    want, _ = tattn.attention_xla(*arrs)
    assert probs is None and torch.equal(out, want)
