"""The port's long-token (> 1024 tokens) ViT path against the JAX package's:
the row kernels' plain versions (timetuning_tpu_torch/ops/fused_block.py)
against the Pallas row kernels in interpret mode and the XLA compositions,
the flash attention branch against its JAX pieces, and the whole ViT over
1,090 tokens against the JAX ViT on carried weights, on the same
numpy-seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetuning_tpu.models.vit import ViTConfig as JViTConfig
from timetuning_tpu.models.vit import VisionTransformer as JViT
from timetuning_tpu.ops import flash_attention as jfa
from timetuning_tpu.ops import fused_block as jfb
from timetuning_tpu_torch.models import vit as tvit
from timetuning_tpu_torch.models.convert import vit_state_dict_from_jax
from timetuning_tpu_torch.ops import fused_block as tfb

torch.set_num_threads(2)

B, S, D, HEADS, HID = 2, 37, 32, 4, 64
# the registry's vit-tiny-test-p4: at input 132 a 33x33 patch grid, 1,090
# tokens with the CLS token
TINY_P4 = dict(patch_size=4, embed_dim=32, depth=2, num_heads=2, img_size=32)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)

    def a(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = a(B, S, D)
    y = a(B, S, D)
    attn = (1 + a(D, scale=0.1), a(D, scale=0.1), a(D, 3 * D, scale=D ** -0.5),
            a(3 * D, scale=0.1), a(D, D, scale=D ** -0.5), a(D, scale=0.1))
    mlp = (1 + a(D, scale=0.1), a(D, scale=0.1), a(D, HID, scale=D ** -0.5),
           a(HID, scale=0.1), a(HID, D, scale=HID ** -0.5), a(D, scale=0.1))
    return x, y, attn, mlp


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def test_dense_residual_plain_matches_jax_xla():
    x, y, attn, _ = _inputs(1)
    args = [y, x, attn[4], attn[5]]
    want = jfb.dense_residual_xla(*_j(args))
    got = tfb.dense_residual_xla(*_t(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernel", ["ln_dense", "dense_residual", "mlp_rows"])
def test_row_wrappers_match_pallas_row_kernels_interpret(kernel):
    """The CPU path of each row-kernel wrapper against the TPU row kernel
    itself, 16-row tiles over 74 rows (a ragged last tile)."""
    x, y, attn, mlp = _inputs(2)
    ln_s, ln_b, w_qkv, b_qkv, w_proj, b_proj = attn
    if kernel == "ln_dense":
        args, jfn, tfn = ([x, ln_s, ln_b, w_qkv, b_qkv], jfb._ln_dense_pallas,
                          tfb.ln_dense_rows)
    elif kernel == "dense_residual":
        args, jfn, tfn = ([y, x, w_proj, b_proj], jfb._dense_residual_pallas,
                          tfb.dense_residual_rows)
    else:
        args, jfn, tfn = [x, *mlp], jfb._mlp_rows_pallas, tfb.mlp_rows
    want = jfn(*_j(args), block_rows=16, interpret=True)
    got = tfn(*_t(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_flash_attention_branch_matches_jax_pieces():
    """ln_dense_rows -> flash core -> dense_residual_rows, the plain
    composition, against the same chain of JAX pieces: the two row kernels
    in interpret mode around the JAX flash core (its XLA path on the CPU),
    and against JAX's attention_block_xla."""
    x, _, attn, _ = _inputs(3)
    ln_s, ln_b, wq, bq, wp, bp = _j(attn)
    xj = jnp.asarray(x)
    qkv = jfb._ln_dense_pallas(xj, ln_s, ln_b, wq, bq, block_rows=16,
                               interpret=True).reshape(B, S, 3, HEADS, D // HEADS)
    q, k, v = (jnp.transpose(qkv[:, :, i], (0, 2, 1, 3)) for i in range(3))
    merged = jnp.transpose(jfa.flash_attention(q, k, v), (0, 2, 1, 3)).reshape(B, S, D)
    want = jfb._dense_residual_pallas(merged, xj, wp, bp, block_rows=16,
                                      interpret=True)
    got = tfb.attention_block_branch_flash(*_t([x, *attn]), num_heads=HEADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(jfb.attention_block_xla(xj, ln_s, ln_b, wq, bq, wp, bp,
                                           num_heads=HEADS)),
        rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def p4_params():
    """vit-tiny-test-p4 params, every leaf perturbed so biases and LayerNorm
    parameters are not at their trivial init."""
    model = JViT(JViTConfig(**TINY_P4, attn_impl="xla"))
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)


def _forward_pair(params, jdt, tdt, monkeypatch):
    """Both ViTs on one 132x132 frame; the port's Block routing recorded."""
    routes = []
    for name in ("attention_block_branch", "attention_block_branch_flash",
                 "mlp_block_branch", "mlp_rows"):
        fn = getattr(tvit, name)
        monkeypatch.setattr(tvit, name,
                            lambda *a, _n=name, _f=fn, **kw: routes.append(_n) or _f(*a, **kw))
    x = np.random.default_rng(132).standard_normal((1, 132, 132, 3)).astype(np.float32)
    jm = JViT(JViTConfig(**TINY_P4, dtype=jdt))
    want = jm.apply({"params": params}, jnp.asarray(x))["tokens"]
    tm = tvit.VisionTransformer(tvit.ViTConfig(**TINY_P4, dtype=tdt))
    tm.load_state_dict(vit_state_dict_from_jax(params))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))["tokens"]
    assert got.shape == (1, 1090, 32)
    return got, np.asarray(want, np.float32), routes


def test_long_token_vit_matches_jax_f32(p4_params, monkeypatch):
    """f32 over 1,090 tokens: the plain composition, at test_torch_vit's f32
    tolerance."""
    got, want, routes = _forward_pair(p4_params, jnp.float32, torch.float32,
                                      monkeypatch)
    assert routes == []
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_long_token_vit_matches_jax_bf16(p4_params, monkeypatch):
    """bf16 over 1,090 tokens: every block takes the flash branch and the
    row MLP (their plain versions here), the JAX ViT its bf16 XLA path;
    bound: bf16 rounding accumulated over two blocks."""
    got, want, routes = _forward_pair(p4_params, jnp.bfloat16, torch.bfloat16,
                                      monkeypatch)
    assert routes == ["attention_block_branch_flash", "mlp_rows"] * 2
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2, atol=5e-2)
    cos = torch.nn.functional.cosine_similarity(got.float(), torch.from_numpy(want),
                                                dim=-1)
    assert cos.min().item() > 0.999


def test_short_sequences_keep_the_whole_block_branches(p4_params, monkeypatch):
    """At 1,024 tokens and below (here 257) a bf16 block keeps kernels 1 and
    2, as the JAX Block's gate (vit.py:248-251)."""
    routes = []
    for name in ("attention_block_branch", "mlp_block_branch"):
        fn = getattr(tvit, name)
        monkeypatch.setattr(tvit, name,
                            lambda *a, _n=name, _f=fn, **kw: routes.append(_n) or _f(*a, **kw))
    tm = tvit.VisionTransformer(tvit.ViTConfig(**TINY_P4, dtype=torch.bfloat16))
    tm.load_state_dict(vit_state_dict_from_jax(p4_params))
    with torch.no_grad():
        tm(torch.zeros(1, 64, 64, 3))
    assert routes == ["attention_block_branch", "mlp_block_branch"] * 2
