"""The backward of the port's kernel wrappers against the JAX package's
custom VJPs, on the same numpy-seeded inputs and cotangents.

JAX differentiates through every block kernel (``attention_block_branch``,
``mlp_block_branch``, ``ln_dense_rows``, ``dense_residual_rows``: a Pallas
forward, the VJP of the XLA composition backward) and through the flash core
(``_chunked_bwd``, the streamed analytic gradient). Here the JAX forwards
run their Pallas kernels in interpret mode; the port's wrappers run on CPU
tensors, where the forward inside the autograd Function is the plain
version and the backward is the code under test. f32, atol 1e-5. Also one
train step with ``grad_attn_impl=None`` in bf16, the differentiated pass
through the block wrappers, against the JAX step with the same setting."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetuning_tpu.core import optimizer as jopt
from timetuning_tpu.core import timet as jt
from timetuning_tpu.models.extractor import FeatureExtractor as JFeatureExtractor
from timetuning_tpu.models.vit import ViTConfig as JViTConfig
from timetuning_tpu.models.vit import VisionTransformer as JVisionTransformer
from timetuning_tpu.ops import flash_attention as jfa
from timetuning_tpu.ops import fused_block as jfb
from timetuning_tpu_torch.core import timet as tt
from timetuning_tpu_torch.core.optimizer import swav_optimizer
from timetuning_tpu_torch.models.convert import timet_state_dict_from_jax
from timetuning_tpu_torch.models.extractor import FeatureExtractor
from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer
from timetuning_tpu_torch.ops import flash_attention as tfa
from timetuning_tpu_torch.ops import fused_block as tfb
from timetuning_tpu_torch.ops import kernel_lib

from test_torch_timet import HEAD, K, UNFREEZE, VIT, _clips

torch.set_num_threads(2)

B, S, D, HEADS, HID = 2, 13, 32, 2, 128
ATOL = 1e-5


def _a(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _block_args(name, seed):
    rng = np.random.default_rng(seed)
    x = _a(rng, B, S, D)
    ln = [1 + _a(rng, D, scale=0.1), _a(rng, D, scale=0.1)]
    if name == "attention_block_branch":
        return [x, *ln, _a(rng, D, 3 * D, scale=D ** -0.5), _a(rng, 3 * D, scale=0.1),
                _a(rng, D, D, scale=D ** -0.5), _a(rng, D, scale=0.1)]
    if name in ("mlp_block_branch", "mlp_rows"):
        return [x, *ln, _a(rng, D, HID, scale=D ** -0.5), _a(rng, HID, scale=0.1),
                _a(rng, HID, D, scale=HID ** -0.5), _a(rng, D, scale=0.1)]
    if name == "ln_dense_rows":
        return [x, *ln, _a(rng, D, 3 * D, scale=D ** -0.5), _a(rng, 3 * D, scale=0.1)]
    return [x, _a(rng, B, S, D), _a(rng, D, D, scale=D ** -0.5), _a(rng, D, scale=0.1)]


def _interpret(monkeypatch):
    """The JAX forwards' Pallas kernels in interpret mode (their custom
    VJPs look the kernels up by name when called)."""
    monkeypatch.setattr(jfb, "_attn_pallas", functools.partial(
        jfb._attn_pallas, block_b=1, interpret=True))
    monkeypatch.setattr(jfb, "_mlp_pallas", functools.partial(
        jfb._mlp_pallas, block_b=1, interpret=True))
    monkeypatch.setattr(jfb, "_ln_dense_pallas", functools.partial(
        jfb._ln_dense_pallas, block_rows=16, interpret=True))
    monkeypatch.setattr(jfb, "_dense_residual_pallas", functools.partial(
        jfb._dense_residual_pallas, block_rows=16, interpret=True))


# port wrapper -> JAX custom-VJP entry point (kernel 9's rows kernel is the
# JAX mlp_block_branch's long-sequence branch, with the same VJP)
ENTRIES = {
    "attention_block_branch": (tfb.attention_block_branch,
                               lambda *a: jfb.attention_block_branch(*a, HEADS)),
    "mlp_block_branch": (tfb.mlp_block_branch, jfb.mlp_block_branch),
    "mlp_rows": (tfb.mlp_rows, jfb.mlp_block_branch),
    "ln_dense_rows": (tfb.ln_dense_rows, jfb.ln_dense_rows),
    "dense_residual_rows": (tfb.dense_residual_rows, jfb.dense_residual_rows),
}


@pytest.mark.parametrize("name", list(ENTRIES))
def test_block_wrapper_gradients_match_jax_vjp(monkeypatch, name):
    _interpret(monkeypatch)
    tfn, jfn = ENTRIES[name]
    args = _block_args(name, seed=len(name))
    kw = {"num_heads": HEADS} if name == "attention_block_branch" else {}
    out_j, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    g = np.random.default_rng(1).standard_normal(out_j.shape).astype(np.float32)
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out_t = tfn(*leaves, **kw)
    assert out_t.grad_fn is not None
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-4,
                               atol=ATOL)
    got = torch.autograd.grad(out_t, leaves, torch.from_numpy(g))
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=ATOL,
                                   err_msg=f"{name} input {i}")


def test_gradient_flows_to_the_inputs_asked_for_only():
    """Inputs that do not require grad get none, and a wrapper called under
    no_grad builds no graph (the eager path calls the wrapper directly)."""
    args = [torch.from_numpy(a) for a in _block_args("mlp_block_branch", 3)]
    w1 = args[3].clone().requires_grad_(True)
    out = tfb.mlp_block_branch(args[0], args[1], args[2], w1, *args[4:])
    out.sum().backward()
    assert w1.grad is not None and w1.grad.abs().sum() > 0
    with torch.no_grad():
        assert tfb.mlp_block_branch(args[0], args[1], args[2], w1, *args[4:]).grad_fn is None


@pytest.mark.parametrize("Dh", [32, 64])
@pytest.mark.parametrize("Sq,Sk,kv_len", [(300, 300, None), (300, 300, 250),
                                          (260, 300, 299)])
def test_flash_gradients_match_jax_chunked_bwd(Sq, Sk, kv_len, Dh):
    """S = 300: two query chunks of 256, the second padded; a key mask
    inside the last chunk; local queries against more keys."""
    rng = np.random.default_rng(Sq + Dh + (kv_len or 0))
    q, k, v = _a(rng, 1, 2, Sq, Dh), _a(rng, 1, 2, Sk, Dh), _a(rng, 1, 2, Sk, Dh)
    g = _a(rng, 1, 2, Sq, Dh)
    out_j, vjp = jax.vjp(lambda *a: jfa.flash_attention(*a, kv_len=kv_len),
                         *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out_t = tfa.flash_attention(*leaves, kv_len=kv_len)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=ATOL)
    got = torch.autograd.grad(out_t, leaves, torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=ATOL)
    direct = tfa.flash_attention_bwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                     torch.from_numpy(g), kv_len, block_q=64)
    for a, b in zip(direct, want):      # the chunk size changes no number
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=ATOL)


def test_long_block_branch_differentiates_through_rows_and_flash():
    """The > 1024-token attention branch (ln_dense -> flash -> dense
    residual) at 1,030 tokens, every stage with its backward: the gradient
    of x against autograd through the plain composition."""
    rng = np.random.default_rng(5)
    D2, H2 = 64, 2
    x = torch.from_numpy(_a(rng, 1, 1030, D2)).requires_grad_(True)
    w = [torch.from_numpy(a) for a in (1 + _a(rng, D2, scale=0.1), _a(rng, D2, scale=0.1),
                                       _a(rng, D2, 3 * D2, scale=D2 ** -0.5),
                                       _a(rng, 3 * D2, scale=0.1),
                                       _a(rng, D2, D2, scale=D2 ** -0.5),
                                       _a(rng, D2, scale=0.1))]
    (got,) = torch.autograd.grad(
        tfb.attention_block_branch_flash(x, *w, H2).square().sum(), [x])
    (want,) = torch.autograd.grad(
        tfb.attention_block_xla(x, *w, H2).square().sum(), [x])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_bf16_step_through_the_block_kernels_matches_jax(monkeypatch):
    """``grad_attn_impl=None`` on a bf16 ``auto`` model: the differentiated
    pass goes through the block wrappers' Functions (on the CPU: the plain
    compositions forward, their VJPs backward), as JAX's step with the same
    setting goes through its blocks' custom VJPs. First loss within 2e-3 of
    JAX's (the bound the card's forced-kernel step is held to)."""
    cfg_kw = dict(n_prototypes=K, spatial_resolution=4, num_epochs=1,
                  steps_per_epoch=10, frozen_trunk_blocks=1, grad_attn_impl=None)
    clip = _clips(1)[0]
    jmodel = jt.TimeT(feature_extractor=JFeatureExtractor(
        JVisionTransformer(JViTConfig(attn_impl="auto", dtype=jnp.bfloat16, **VIT)),
        head_dims=HEAD), n_prototypes=K)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))["params"]
    jcfg = jt.TimeTConfig(**cfg_kw)
    tx, jmask = jopt.swav_optimizer(params, lr=1e-3, unfreeze_layers=UNFREEZE,
                                    opt_over_trainable=True, num_epochs=1,
                                    steps_per_epoch=10)
    jstate = jt.init_state(jmodel, jcfg, tx, jax.random.PRNGKey(0), None,
                           params=params, trainable_mask=jmask)
    jstep = jax.jit(jt.make_train_step(jmodel, jcfg, tx, trainable_mask=jmask,
                                       opt_over_trainable=True))
    rng = jax.random.PRNGKey(7)
    _, m = jstep(jstate, jnp.asarray(clip), rng)
    jloss = float(m["loss"])

    drawn = np.asarray(jax.random.permutation(rng, clip.shape[0] * 16)[:clip.shape[0] * 10])
    monkeypatch.setattr(tt, "queue_store_indices",
                        lambda n, k, g: torch.from_numpy(drawn.astype(np.int64)))
    calls = []
    fwd = kernel_lib._PlainVJP.forward

    def counting(ctx, kernel, plain, *args):
        calls.append(kernel.__name__)
        return fwd(ctx, kernel, plain, *args)

    monkeypatch.setattr(kernel_lib._PlainVJP, "forward", staticmethod(counting))
    tmodel = tt.TimeT(FeatureExtractor(VisionTransformer(ViTConfig(
        dtype=torch.bfloat16, attn_impl="auto", **VIT)), VIT["embed_dim"], HEAD), K)
    tmodel.load_state_dict(timet_state_dict_from_jax(params))
    tcfg = tt.TimeTConfig(**cfg_kw)
    opt, tmask = swav_optimizer(tmodel, lr=1e-3, unfreeze_layers=UNFREEZE,
                                opt_over_trainable=True, num_epochs=1, steps_per_epoch=10)
    tstate = tt.init_state(tmodel, tcfg, opt, trainable_mask=tmask)
    step = tt.make_train_step(tmodel, tcfg, opt, trainable_mask=tmask,
                              opt_over_trainable=True)
    _, tm = step(tstate, torch.from_numpy(clip), None)
    assert abs(float(tm["loss"]) - jloss) <= 2e-3
    # the trainable blocks 1 and 2, each branch once, on the grad path
    assert sorted(set(calls)) == ["attention_block_branch", "mlp_block_branch"]
    assert len(calls) == 4
