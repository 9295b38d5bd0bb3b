"""The port's whole-sequence attention (timetuning_tpu_torch/ops/attention.py:
``attention_mha_plain``, the plain version of kernel 10; the autograd
Function's backward; the dispatcher by ``impl``) against the JAX package's
``attention_xla``, its TPU kernel ``_mha_kernel`` run in interpret mode, and
``jax.grad`` through its custom VJP's formula, on the same numpy-seeded
inputs."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from timetuning_tpu.ops import attention as jattn
from timetuning_tpu.ops.util import pad_to_multiple
from timetuning_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)


def _qkv(B, H, S, Dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, S, Dh)).astype(np.float32) for _ in range(3)]


def _mha_kernel_interpret(q, k, v):
    """``attention_pallas`` (timetuning_tpu/ops/attention.py:80-122) with its
    padding (S and Dh to 128, one (batch, head) pair a grid step), the
    kernel run in interpret mode, without the TPU memory space."""
    B, H, S, Dh = q.shape
    Sp, Dp, G = pad_to_multiple(S), pad_to_multiple(Dh), B * H

    def prep(x):
        return jnp.pad(x.reshape(G, S, Dh), ((0, 0), (0, Sp - S), (0, Dp - Dh)))

    spec = pl.BlockSpec((1, Sp, Dp), lambda i: (i, 0, 0))
    out = pl.pallas_call(
        functools.partial(jattn._mha_kernel, scale=1.0 / math.sqrt(Dh), seq_len=S),
        out_shape=jax.ShapeDtypeStruct((G, Sp, Dp), q.dtype),
        grid=(G,), in_specs=[spec, spec, spec], out_specs=spec, interpret=True,
    )(prep(q), prep(k), prep(v))
    return out[:, :S, :Dh].reshape(B, H, S, Dh)


@pytest.mark.parametrize("B,H,S,Dh", [(2, 2, 37, 16), (1, 3, 197, 64)])
def test_plain_matches_jax_xla_and_tpu_kernel_f32(B, H, S, Dh):
    """f32: 2e-6 absolute on outputs of order 1 (sums in another order)."""
    q, k, v = _qkv(B, H, S, Dh, seed=S)
    got = tattn.attention_mha_plain(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    want_xla = np.asarray(jattn.attention_xla(*(jnp.asarray(a) for a in (q, k, v)))[0])
    want_kernel = np.asarray(_mha_kernel_interpret(*(jnp.asarray(a) for a in (q, k, v))))
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=2e-6)


def test_plain_matches_tpu_kernel_bf16():
    """bf16: the probabilities are rounded to bf16 before p @ v in both; one
    p rounding the other way moves an output of order 1 by < 2^-8, and the
    output itself is rounded to bf16 (2^-8 relative)."""
    q, k, v = _qkv(1, 2, 70, 64, seed=11)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    got = tattn.attention_mha_plain(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    want = np.asarray(_mha_kernel_interpret(jq, jk, jv).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 ** -7)


@pytest.mark.parametrize("S", [37, 197])
def test_plain_matches_tpu_kernel_bf16_at_32_wide_heads(S):
    """MoCo-v3 ViT-S/16's twelve heads of 32 (the TPU kernel takes any
    head width, ``Dh = D // num_heads``): kernel 10's plain version against
    ``_mha_kernel`` in interpret mode, in bf16 at the bound above, and in
    f32 at 2e-6."""
    q, k, v = _qkv(1, 12, S, 32, seed=S + 32)
    got = tattn.attention_mha_plain(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    want = _mha_kernel_interpret(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=2 ** -7)
    got = tattn.attention_mha_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    want = _mha_kernel_interpret(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)


def test_forced_dispatch_takes_f32_32_wide_heads():
    """``attention(..., impl="pallas")`` in f32 at heads of 32 (kernel 10's
    f32 form, refused before it took Dh 32): on CPU tensors the wrapper's
    plain version, against ``_mha_kernel`` in interpret mode at 2e-6; its
    gradient is ``_AttentionFused``'s, equal to autograd through the plain
    version at 1e-5."""
    q, k, v = _qkv(2, 12, 50, 32, seed=50)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out, _ = tattn.attention(*leaves, impl="pallas")
    want = _mha_kernel_interpret(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=2e-6)
    g = torch.from_numpy(np.random.default_rng(51).standard_normal(q.shape).astype(np.float32))
    got = torch.autograd.grad(out, leaves, g)
    plain = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    ref = torch.autograd.grad(tattn.attention_mha_plain(*plain), plain, g)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_kernel_wrapper_takes_32_wide_heads_in_bf16_only():
    """Heads of 32 pass the wrapper's width check in bf16 and, since the f32
    core took heads of 32 too, in f32 (a meta tensor then stops at the device
    check); heads of 48 raise the width error before it in either dtype."""
    for dt in (torch.bfloat16, torch.float32):
        m = torch.zeros(1, 12, 8, 32, device="meta", dtype=dt)
        with pytest.raises(ValueError, match="expected CUDA tensors"):
            tattn.attention_mha(m, m, m)
        m = torch.zeros(1, 2, 8, 48, device="meta", dtype=dt)
        with pytest.raises(ValueError, match="32- or 64-wide heads"):
            tattn.attention_mha(m, m, m)


@pytest.mark.parametrize("S,plan", [
    (1, (1, 64)), (64, (1, 64)), (65, (1, 128)), (128, (1, 128)), (129, (1, 208)),
    (197, (1, 208)), (208, (1, 208)), (209, (1, 256)), (256, (1, 256)),
    (257, (2, 384)), (700, (2, 768)), (1024, (2, 1024))])
def test_mha_plan_by_sequence_length(S, plan):
    """One pass up to 256 tokens, over the narrowest strip the kernel has that
    holds the sequence; two passes up to 1024, over whole 128-key chunks. The
    key count handed to the kernel covers the sequence and is a whole number
    of the second product's 16-key steps."""
    assert tattn.mha_plan(S) == plan
    passes, keys = plan
    assert keys >= S and keys % 16 == 0
    if passes == 1:
        assert keys in tattn.ONE_PASS_KEYS and keys <= 256
        assert not any(S <= n < keys for n in tattn.ONE_PASS_KEYS)
    else:
        assert keys % tattn.TWO_PASS_CHUNK == 0 and keys - S < tattn.TWO_PASS_CHUNK


@pytest.mark.parametrize("S", [0, -3, 1025, 3137])
def test_mha_plan_raises_outside_the_kernels_range(S):
    with pytest.raises(ValueError, match="at most 1024 tokens"):
        tattn.mha_plan(S)


@pytest.mark.parametrize("S", [5, 197, 257])
def test_wrapper_on_cpu_matches_tpu_kernel_bf16(S):
    """The kernel's wrapper given CPU tensors (its plain version, whatever
    the plan for S) against ``_mha_kernel`` in interpret mode, on the strided
    q, k, v views of a qkv buffer; bound as the plain version's above."""
    qkv = np.random.default_rng(S).standard_normal((1, S, 3, 2, 64)).astype(np.float32)
    t = torch.from_numpy(qkv).bfloat16()
    tq, tk, tv = (t[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    got = tattn.attention_mha(tq, tk, tv)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 2, S, 64)
    assert torch.equal(got, tattn.attention_mha_plain(tq, tk, tv))
    j = jnp.asarray(qkv).astype(jnp.bfloat16)
    want = _mha_kernel_interpret(*(j[:, :, i].transpose(0, 2, 1, 3) for i in range(3)))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=0, atol=2 ** -7)


def test_function_backward_matches_jax_custom_vjp():
    """The Function's backward against ``_attention_fused_bwd`` itself and
    against ``jax.grad`` through plain attention, f32, 1e-5."""
    q, k, v = _qkv(2, 2, 23, 16, seed=3)
    g = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out, probs = tattn.attention(tq, tk, tv, impl="pallas")
    assert probs is None and out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jattn._attention_fused_bwd((jq, jk, jv), jnp.asarray(g))
    auto = jax.grad(lambda a, b, c: jnp.sum(jattn.attention_xla(a, b, c)[0] * g),
                    argnums=(0, 1, 2))(jq, jk, jv)
    for t, w, a in zip((tq, tk, tv), want, auto):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(a), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "xla", "pallas", "fused"])
@pytest.mark.parametrize("S", [197, 1025])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dispatcher_table(impl, S, dtype):
    """Every ``impl`` value: the forced impls ignore dtype and device, auto
    follows the dtype contract on the card and is plain off it."""
    route = functools.partial(tattn.attention_route, dtype, S, False)
    kernel = "flash" if S > 1024 else "mha"
    if impl in ("pallas", "fused"):
        assert route(on_cuda=True, impl=impl) == route(on_cuda=False, impl=impl) == kernel
        with pytest.raises(RuntimeError, match="probabilities are only available"):
            tattn.attention_route(dtype, S, True, True, impl)
    elif impl == "xla":
        assert route(on_cuda=True, impl=impl) == route(on_cuda=False, impl=impl) == "plain"
        assert tattn.attention_route(dtype, S, True, True, impl) == "plain"
    else:
        wants = dtype == torch.bfloat16 or S > 1024
        assert route(on_cuda=True, impl=impl) == (kernel if wants else "plain")
        assert route(on_cuda=False, impl=impl) == "plain"
        assert tattn.attention_route(dtype, S, True, True, impl) == "plain"


def test_dispatcher_errors():
    q = torch.zeros(1, 1, 5, 8)
    with pytest.raises(ValueError, match="unknown impl"):
        tattn.attention(q, q, q, impl="mosaic")
    with pytest.raises(RuntimeError, match="mask_features"):
        tattn.attention(q, q, q, return_probs=True, impl="fused")
    # the JAX dispatcher's error for the same request
    jq = jnp.zeros((1, 1, 5, 8))
    with pytest.raises(RuntimeError, match="only available through the XLA"):
        jattn.attention(jq, jq, jq, return_probs=True, impl="pallas")


def test_forced_impl_runs_the_plain_version_on_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 30, 16, seed=6))
    out, _ = tattn.attention(q, k, v, impl="pallas")
    assert torch.equal(out, tattn.attention_mha_plain(q, k, v))
    np.testing.assert_allclose(out.numpy(), tattn.attention_xla(q, k, v)[0].numpy(),
                               rtol=0, atol=2e-6)


def test_kernel_wrapper_refuses_grad_and_bad_shapes():
    """The wrapper differentiates (``_AttentionFused``: the analytic
    gradient, equal to autograd through the plain version) where it once
    refused an input that requires grad; it still refuses shapes and types
    the kernel does not take."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 8, 64, seed=9))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = [t.clone().requires_grad_(True) for t in (q, k, v)]
    g = torch.from_numpy(np.random.default_rng(10).normal(size=q.shape).astype(np.float32))
    got = torch.autograd.grad(tattn.attention_mha(*leaves), leaves, g)
    ref = torch.autograd.grad(tattn.attention_mha_plain(*want), want, g)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    m = torch.zeros(1, 2, 8, 48, device="meta")
    with pytest.raises(ValueError, match="32- or 64-wide heads"):
        tattn.attention_mha(m, m, m)
    m = torch.zeros(1, 2, 1025, 64, device="meta")
    with pytest.raises(ValueError, match="at most 1024 tokens"):
        tattn.attention_mha(m, m, m)
    m = torch.zeros(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="bf16 or all f32"):
        tattn.attention_mha(m, m, m.half())
