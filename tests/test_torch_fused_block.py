"""The port's ViT block branches (timetuning_tpu_torch/ops/fused_block.py)
against the JAX package's: the plain compositions against the XLA ones, and
against the Pallas whole-block kernels in interpret mode, on the same
numpy-seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetuning_tpu.ops import fused_block as jfb
from timetuning_tpu_torch.ops import fused_block as tfb

torch.set_num_threads(2)

B, S, D, HEADS, HID = 2, 13, 32, 2, 128


def _inputs(seed=0):
    rng = np.random.default_rng(seed)

    def a(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = a(B, S, D)
    attn = (1 + a(D, scale=0.1), a(D, scale=0.1), a(D, 3 * D, scale=D ** -0.5),
            a(3 * D, scale=0.1), a(D, D, scale=D ** -0.5), a(D, scale=0.1))
    mlp = (1 + a(D, scale=0.1), a(D, scale=0.1), a(D, HID, scale=D ** -0.5),
           a(HID, scale=0.1), a(HID, D, scale=HID ** -0.5), a(D, scale=0.1))
    return x, attn, mlp


def _j(arrs, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrs]


def _t(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def test_attention_block_plain_matches_jax_xla():
    x, attn, _ = _inputs()
    want = jfb.attention_block_xla(*_j([x, *attn]), num_heads=HEADS)
    got = tfb.attention_block_xla(*_t([x, *attn]), num_heads=HEADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_mlp_block_plain_matches_jax_xla():
    x, _, mlp = _inputs(1)
    want = jfb.mlp_block_xla(*_j([x, *mlp]))
    got = tfb.mlp_block_xla(*_t([x, *mlp]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_ln_dense_plain_matches_jax_xla():
    x, attn, _ = _inputs(2)
    args = [x, attn[0], attn[1], attn[2], attn[3]]
    want = jfb.ln_dense_xla(*_j(args))
    got = tfb.ln_dense_xla(*_t(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_attention_branch_matches_pallas_kernel_interpret():
    """The CPU path of the kernel wrapper against the TPU kernel itself."""
    x, attn, _ = _inputs(3)
    want = jfb._attn_pallas(*_j([x, *attn]), num_heads=HEADS, block_b=1,
                            interpret=True)
    got = tfb.attention_block_branch(*_t([x, *attn]), num_heads=HEADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_mlp_branch_matches_pallas_kernel_interpret():
    x, _, mlp = _inputs(4)
    want = jfb._mlp_pallas(*_j([x, *mlp]), block_b=1, interpret=True)
    got = tfb.mlp_block_branch(*_t([x, *mlp]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_bf16_branches_match_jax_at_bf16_rounding():
    """bf16 activations and weights, f32 LayerNorm params and biases (the
    Block's contract): the port's plain path against the JAX composition
    at bf16 tolerance."""
    x, attn, mlp = _inputs(5)
    for fn_j, fn_t, w, kw in (
            (jfb.attention_block_xla, tfb.attention_block_branch, attn,
             {"num_heads": HEADS}),
            (jfb.mlp_block_xla, tfb.mlp_block_branch, mlp, {})):
        # weights (operands 2 and 4) in bf16, LN params and biases in f32
        wj = [jnp.asarray(a, jnp.bfloat16 if i in (2, 4) else jnp.float32)
              for i, a in enumerate(w)]
        wt = [torch.from_numpy(a).to(torch.bfloat16 if i in (2, 4) else torch.float32)
              for i, a in enumerate(w)]
        want = fn_j(jnp.asarray(x, jnp.bfloat16), *wj, **kw)
        got = fn_t(torch.from_numpy(x).to(torch.bfloat16), *wt, **kw)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("branch", ["attention", "mlp"])
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(branch):
    """A non-CPU tensor never reaches the plain version: wrong dtype or a
    non-CUDA device raises before any launch (meta tensors stand in for a
    device here)."""
    x, attn, mlp = _inputs(6)
    w = [torch.from_numpy(a).to("meta") for a in (attn if branch == "attention" else mlp)]
    fn = (lambda x: tfb.attention_block_branch(x, *w, num_heads=HEADS)
          if branch == "attention" else tfb.mlp_block_branch(x, *w))
    with pytest.raises(ValueError, match="bf16"):
        fn(torch.from_numpy(x).to("meta"))
    with pytest.raises(ValueError):
        fn(torch.from_numpy(x).to("meta", torch.bfloat16))
