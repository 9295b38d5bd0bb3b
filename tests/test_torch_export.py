"""The port's serving export (timetuning_tpu_torch/cli/export.py) and the
kernels' custom ops (ops/kernel_lib.kernel_entry), on the CPU.

``export_features`` + ``load_exported`` at ``vit-tiny-test`` (32 px, f32,
``--device cpu``) against the JAX package's ``export_features`` live forward
on the same weights (a reference-layout .pth that both load): atol 1e-4. A
bf16 ``auto`` ViT exported through the custom ops, at 17 and at 1,090
tokens (the whole-block and the row/flash branches), the program against
the live forward; the symbolic-batch program at batches 2, 3 and 5; each
op's fake against its real output (shape, dtype, strides); the flags'
checks, JAX's, and the MoE program."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetuning_tpu.cli import export as jexport
from timetuning_tpu.models.registry import get_backbone as jget_backbone
from timetuning_tpu_torch.cli import export as texport
from timetuning_tpu_torch.models.export_torch import vit_params_to_torch
from timetuning_tpu_torch.models.vit import ViTConfig, VisionTransformer
from timetuning_tpu_torch.ops import attention as tat
from timetuning_tpu_torch.ops import flash_attention as tfa
from timetuning_tpu_torch.ops import fused_block as tfb
from timetuning_tpu_torch.ops import kernel_lib
from timetuning_tpu_torch.ops import preprocess_cuda as tpc

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny_pth(tmp_path_factory):
    """The JAX registry's seeded vit-tiny-test weights as a reference-layout
    checkpoint, so both exporters load the same numbers."""
    bb = jget_backbone("vit-tiny-test")
    sd = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in vit_params_to_torch(bb.variables["params"]).items()}
    path = tmp_path_factory.mktemp("export") / "tiny.pth"
    torch.save(sd, str(path))
    return str(path)


def _frames(b, seed, size=32):
    return np.random.default_rng(seed).integers(0, 256, (b, size, size, 3), np.uint8)


@pytest.mark.parametrize("symbolic", [False, True])
def test_program_matches_jax_live_forward(tiny_pth, symbolic):
    blob, live, shape, mesh = texport.export_features(
        "vit-tiny-test", tiny_pth, 3, 32, "float32", symbolic_batch=symbolic,
        device="cpu")
    assert mesh is None and shape == (3, 32, 32, 3)
    fn = texport.load_exported(io.BytesIO(blob))
    _, jlive, _, _ = jexport.export_features("vit-tiny-test", tiny_pth, 3, 32, "float32")
    for b in ((2, 3, 5) if symbolic else (3,)):
        x = _frames(b, seed=b)
        with torch.no_grad():
            got = fn(torch.from_numpy(x))
            live_out = live(torch.from_numpy(x))
        want = np.asarray(jlive(jnp.asarray(x)))
        assert got.shape == want.shape == (b, 16, 32)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), live_out.numpy(), rtol=0, atol=1e-5)


def test_moe_program_matches_jax_live_forward(tiny_pth, tmp_path, capsys):
    """``--moe_every_k 2 --moe_experts 4``: the program of the MoE ViT
    upcycled from the dense weights (blocks 1 and 3 MoE, every expert a copy
    of the block's dense MLP) against JAX's live forward of the same MoE
    ViT on the program's weights (the routers are the port's seeded init,
    carried over by models/convert); ``main`` writes and checks it."""
    import dataclasses

    from timetuning_tpu.data.transforms import eval_preprocess_batch
    from timetuning_tpu_torch.models.convert import timet_params_to_jax

    blob, live, _, _ = texport.export_features(
        "vit-tiny-test", tiny_pth, 3, 32, "float32", moe_every_k=2, moe_experts=2,
        device="cpu")
    vit = live.backbone
    dense = torch.load(tiny_pth, weights_only=True)
    assert torch.equal(vit.blocks[1].moe.w1[1], dense["blocks.1.mlp.fc1.weight"].t())
    assert torch.equal(vit.blocks[0].mlp.fc1.weight, dense["blocks.0.mlp.fc1.weight"])
    jb = jget_backbone("vit-tiny-test")
    jm = jb.module.clone(config=dataclasses.replace(jb.module.config, moe_every_k=2,
                                                    n_experts=2))
    jparams = timet_params_to_jax(vit.state_dict())
    fn = texport.load_exported(io.BytesIO(blob))
    x = _frames(3, seed=4)
    want = np.asarray(jm.apply({"params": jparams}, eval_preprocess_batch(
        jnp.asarray(x), out_size=32))["tokens"][:, 1:])
    with torch.no_grad():
        got = fn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    rc = texport.main(["--architecture", "vit-tiny-test", "--model_path", tiny_pth,
                       "--input_resolution", "32", "--batch_size", "2",
                       "--compute_dtype", "float32", "--device", "cpu",
                       "--moe_every_k", "2", "--moe_experts", "2",
                       "--out", str(tmp_path / "moe.pt2")])
    text = capsys.readouterr().out
    assert rc == 0 and "round-trip check: max|Δ| = 0.00e+00" in text, text


def test_main_writes_and_checks_the_program(tmp_path, tiny_pth, capsys):
    out = tmp_path / "f.pt2"
    rc = texport.main(["--architecture", "vit-tiny-test", "--model_path", tiny_pth,
                       "--input_resolution", "32", "--batch_size", "2",
                       "--compute_dtype", "float32", "--device", "cpu",
                       "--symbolic_batch", "true", "--out", str(out)])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert out.stat().st_size > 0
    assert "round-trip check: max|Δ| = 0.00e+00" in text
    assert "symbolic-batch check: batch 3 ok" in text


class _Backbone:
    def __init__(self, module):
        self.module, self.drop_cls = module, True


@pytest.mark.parametrize("size,ops", [
    (32, {"eval_preprocess", "attention_block_branch", "mlp_block_branch"}),
    (132, {"eval_preprocess", "ln_dense_rows", "flash_attention",
           "dense_residual_rows", "mlp_rows"}),
])
def test_bf16_program_calls_the_kernels_as_custom_ops(size, ops):
    """A bf16 ``auto`` ViT (patch 4 at 132 px: 1,090 tokens, the row and
    flash kernels; patch 8 at 32 px: 17 tokens, the block kernels): the
    program holds the preprocess and block kernels as ``timetuning_tpu_torch``
    ops (on CPU tensors their plain versions) and equals the live forward at
    batches 2, 3 and 5 from one symbolic program."""
    patch = 4 if size > 64 else 8
    vit = VisionTransformer(ViTConfig(patch_size=patch, embed_dim=64, depth=2,
                                      num_heads=2, img_size=size, dtype=torch.bfloat16))
    vit.init_weights(torch.Generator().manual_seed(0)).eval()
    live = texport.FeatureForward(_Backbone(vit), size, torch.bfloat16).eval()
    x = torch.from_numpy(_frames(2, 0, size + 8))
    with torch.no_grad():
        program = torch.export.export(live, (x,), strict=False, dynamic_shapes={
            "frames_u8": {0: torch.export.Dim("b")}})
    called = {n.target.name().split("::")[1].split(".")[0]
              for n in program.graph.nodes
              if n.op == "call_function" and "timetuning_tpu_torch" in str(n.target)}
    assert called == ops
    buf = io.BytesIO()
    torch.export.save(program, buf)
    fn = texport.load_exported(io.BytesIO(buf.getvalue()))
    for b in (2, 3, 5):
        x = torch.from_numpy(_frames(b, b, size + 8))
        with torch.no_grad():
            torch.testing.assert_close(fn(x), live(x), rtol=0, atol=0)


def _op_cases():
    rng = np.random.default_rng(0)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    D, Hd = 64, 128
    x = t(2, 9, D, dtype=torch.bfloat16)
    ln = (1 + 0.1 * t(D), 0.1 * t(D))
    q, k, v = t(1, 2, 9, 32), t(1, 2, 11, 32), t(1, 2, 11, 32)
    return {
        "attention_block_branch": (tfb.attention_block_branch,
                                   (x, *ln, t(D, 3 * D), t(3 * D), t(D, D), t(D), 2)),
        "mlp_block_branch": (tfb.mlp_block_branch, (x, *ln, t(D, Hd), t(Hd), t(Hd, D), t(D))),
        "mlp_rows": (tfb.mlp_rows, (x, *ln, t(D, Hd), t(Hd), t(Hd, D), t(D))),
        "ln_dense_rows": (tfb.ln_dense_rows, (x, *ln, t(D, 3 * D), t(3 * D))),
        "dense_residual_rows": (tfb.dense_residual_rows, (x, x, t(D, D), t(D))),
        "flash_attention": (tfa.flash_attention, (q, k, v, 10)),
        "attention_mha": (tat.attention_mha, (q, q, q)),
        "eval_preprocess": (tpc.eval_preprocess_cuda, (
            torch.from_numpy(_frames(2, 1, 40)), 16, [0.4, 0.5, 0.6], [0.2, 0.3, 0.4],
            torch.bfloat16)),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_custom_op_fake_matches_its_real_output(name):
    """torch.library.opcheck's schema and fake-tensor checks (the fake's
    shape, dtype and strides against the real output on CPU tensors, no
    aliasing of inputs), and the op's output equal to the eager wrapper's."""
    entry, args = _op_cases()[name]
    op = entry.op
    assert str(op._opoverload).startswith(f"{kernel_lib.NAMESPACE}.{name}")
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))
    got, want = op(*args), entry(*args)
    assert got.stride() == want.stride()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_export_flag_checks_raise_as_jax():
    """JAX's geometry checks keep their ValueErrors, and a multi-device
    program asks for as many ranks as its mesh has (JAX's "mesh export
    needs N devices", here with no process group: one); the MoE flags
    export a one-device program (against JAX's forward:
    ``test_moe_program_matches_jax_live_forward``; the multi-device programs
    against JAX's: tests/test_torch_export_mesh.py)."""
    kw = dict(architecture="vit-tiny-test", model_path=None, batch_size=2,
              input_resolution=32, compute_dtype="float32", device="cpu")
    for flags in (dict(tensor_parallel=2), dict(data_parallel=2),
                  dict(sequence_parallel=2), dict(pipeline_parallel=2),
                  dict(expert_parallel=2, moe_every_k=2, moe_experts=4)):
        with pytest.raises(ValueError, match="mesh export needs 2 devices, found 1"):
            texport.export_features(**kw, **flags)
    blob, live, shape, mesh = texport.export_features(**kw, moe_every_k=2, moe_experts=4)
    assert blob and mesh is None and live.backbone.blocks[1].moe.w1.shape[0] == 4
    assert shape == (2, 32, 32, 3)
    for flags, msg in ((dict(tensor_parallel=0), ">= 1"),
                       (dict(tensor_parallel=2, sequence_parallel=2), "mutually exclusive"),
                       (dict(expert_parallel=2), "needs a MoE"),
                       (dict(expert_parallel=3, moe_every_k=2, moe_experts=4),
                        "not divisible"),
                       (dict(moe_every_k=2), "BOTH"),
                       (dict(data_parallel=2, symbolic_batch=True), "static-batch"),
                       (dict(data_parallel=4, batch_size=6), "must divide")):
        with pytest.raises(ValueError, match=msg):
            texport.export_features(**{**kw, **flags})
