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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_branch_at_32_wide_heads_matches_pallas_kernel_interpret(dtype):
    """Kernel 1's plain version at heads of 32 (D = 64, two heads: MoCo-v3
    ViT-S/16's head width) against the TPU kernel, which takes any
    ``Dh = D // num_heads``, in interpret mode. f32 as the 64-wide case;
    bf16 to one bf16 ulp of outputs of order 1 (2^-6) plus a p rounded the
    other way."""
    rng = np.random.default_rng(32)
    D = 64
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    attn = [(1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
            (0.1 * rng.standard_normal(D)).astype(np.float32),
            (rng.standard_normal((D, 3 * D)) * D ** -0.5).astype(np.float32),
            (0.1 * rng.standard_normal(3 * D)).astype(np.float32),
            (rng.standard_normal((D, D)) * D ** -0.5).astype(np.float32),
            (0.1 * rng.standard_normal(D)).astype(np.float32)]
    if dtype == "float32":
        want = jfb._attn_pallas(*_j([x, *attn]), num_heads=2, block_b=1, interpret=True)
        got = tfb.attention_block_branch(*_t([x, *attn]), num_heads=2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
        return
    jx = jnp.asarray(x, jnp.bfloat16)
    jw = [jnp.asarray(a, jnp.bfloat16 if a.ndim == 2 else jnp.float32) for a in attn]
    want = jfb._attn_pallas(jx, *jw, num_heads=2, block_b=1, interpret=True)
    tw = [torch.from_numpy(a).to(torch.bfloat16 if a.ndim == 2 else torch.float32)
          for a in attn]
    got = tfb.attention_block_branch(torch.from_numpy(x).bfloat16(), *tw, num_heads=2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=3e-2)


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


def _gelu_f64(h):
    h = h.double()
    return 0.5 * h * (1.0 + torch.special.erf(h / 2.0 ** 0.5))


def test_gelu_kernel_form_is_exact_to_1e6_over_the_f32_range():
    """The kernels' one-range GELU (its torch mirror: the same coefficients,
    f32) against erf in f64: a dense grid of [-12, 12], random values where
    the hidden lives, and every value next to the clamp."""
    rng = np.random.default_rng(0)
    near = np.nextafter(np.float32(tfb.GELU_CLAMP), np.float32([0, 100]))
    h = torch.from_numpy(np.concatenate([
        np.linspace(-12, 12, 2_000_001), rng.uniform(-6.5, 6.5, 500_000),
        2 * rng.standard_normal(500_000), near, -near, [0.0, -0.0, 6.0, -6.0],
    ]).astype(np.float32))
    got = tfb.gelu_kernel_form(h)
    assert got.dtype == torch.float32
    err = (got.double() - _gelu_f64(h)).abs().max().item()
    assert err <= 1e-6, err


def test_gelu_kernel_form_tails_are_exact():
    """Above the range the GELU is its argument and below it 0, exactly; a
    NaN stays one."""
    big = torch.tensor([6.0, 6.5, 12.0, 12.5, 1e3, 3e38, float("inf")])
    assert torch.equal(tfb.gelu_kernel_form(big), big)
    assert torch.equal(tfb.gelu_kernel_form(-big), torch.zeros_like(big))
    assert torch.isnan(tfb.gelu_kernel_form(torch.tensor([float("nan")]))).all()


@pytest.mark.parametrize("scale", [0.5, 0.75, 1.0])
def test_bf16_hidden_from_the_kernel_form_is_within_one_ulp_of_gelus(scale):
    """The hidden is rounded to bf16 once: the two GELUs, 3e-7 apart, then
    round apart on a few values in 10^4, by one ulp of the hidden (or by the
    1e-6 both are exact to, where an ulp is smaller). 10^6 seeded values at
    the spread of a LayerNorm's rows through a Linear layer (far below -4,
    where the GELU is under 1e-4, the two agree to 1e-6 and not to an ulp:
    there erf's own f32 form is no more exact)."""
    h = torch.from_numpy(
        (scale * np.random.default_rng(1).standard_normal(1_000_000)).astype(np.float32))
    got = tfb.gelu_kernel_form(h).bfloat16().float()
    want = torch.nn.functional.gelu(h).bfloat16().float()
    apart = (got - want).abs()
    assert (apart > 0).float().mean().item() <= 1e-3
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(got.abs(), want.abs()))) - 7)
    assert (apart <= torch.clamp(ulp, min=1e-6)).all()


def test_mlp_launches_alone_compose_to_the_branch_on_the_cpu():
    """``mlp_hidden_rows`` and ``mlp_out_rows`` (the two launches of kernels
    2 and 9 apart) take their plain versions on CPU tensors and count no
    launch."""
    from timetuning_tpu_torch.ops import kernel_lib

    x, _, mlp = _inputs(7)
    xt, w = torch.from_numpy(x).bfloat16(), _t(mlp)
    kernel_lib.reset_launch_counts()
    hidden = tfb.mlp_hidden_rows(xt, *w[:4])
    assert hidden.shape == (B, S, HID) and hidden.dtype == torch.bfloat16
    # the second launch sums the residual in f32, the branch's plain version
    # in bf16: one bf16 ulp of O(1) values apart
    torch.testing.assert_close(tfb.mlp_out_rows(hidden, xt, *w[4:]).float(),
                               tfb.mlp_block_xla(xt, *w).float(), atol=2e-2, rtol=2e-2)
    assert not any(kernel_lib.launch_counts().values())


@pytest.mark.parametrize("D,hidden,ok", [
    (384, 1536, True), (768, 3072, True),       # the registry's ViT-S and ViT-B
    (1024, 4096, True), (64, 64, True),
    (32, 128, False), (384, 1500, False), (1088, 4352, False),
])
def test_mlp_wrappers_take_the_widths_they_took(D, hidden, ok):
    """The MLP kernels take widths that are multiples of 64 up to D = 1,024,
    ViT-S's and ViT-B's among them, and refuse the rest before any launch."""
    w1, w2 = torch.empty(D, hidden, device="meta"), torch.empty(hidden, D, device="meta")
    if ok:
        assert tfb._mlp_weights("mlp_block", D, w1, w2) == hidden
        assert tfb.gemm_plan(9850, hidden, D, True, 132).items > 0
        assert tfb.gemm_plan(9850, D, hidden, False, 132).items > 0
    else:
        with pytest.raises(ValueError, match="multiples of 64"):
            tfb._mlp_weights("mlp_block", D, w1, w2)
