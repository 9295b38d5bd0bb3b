"""The port's multi-device ``cli/export`` programs on the CPU: one program a
rank and a manifest, exported by 4 gloo ranks in one spawn
(tests/torch_dp_worker.py) and loaded by 4 fresh ranks in a second. For tp,
sp, pp and ep on 2 x 2 meshes (ep on the MoE ViT upcycled every 2nd block
to 4 experts), dp 4 alone and tp on a 1 x 2 mesh (ranks 2 and 3 past it), at ``vit-tiny-test`` (32 px, f32, batch 4) on
one reference-layout .pth that both packages load: the ranks' features,
joined over the data axis, against JAX's artifact from ``export_features``
with the same flags run on its virtual mesh (atol 2e-5, as
tests/test_cli.py:255-296; 1e-4 where the MoE routes), each program
against its rank's live mesh forward, ``main``'s round-trip check and mesh
note, and the loader's refusal of another world size."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from test_torch_export import tiny_pth  # noqa: F401 (a fixture)
from timetuning_tpu.cli import export as jexport
from timetuning_tpu.models.registry import get_backbone as jget_backbone
from timetuning_tpu.parallel.ep import upcycle_dense_to_moe
from timetuning_tpu_torch.cli import export as texport
from timetuning_tpu_torch.models.convert import vit_state_dict_from_jax
from torch_dp_worker import spawn

WORLD, B = 4, 4
MOE = dict(moe_every_k=2, moe_experts=4)
PROGRAMS = {
    "tp": dict(tensor_parallel=2, data_parallel=2),
    "sp": dict(sequence_parallel=2, data_parallel=2),
    "pp": dict(pipeline_parallel=2, data_parallel=2),
    "ep": dict(expert_parallel=2, data_parallel=2, **MOE),
    "dp": dict(data_parallel=4),
    "tp 1x2": dict(tensor_parallel=2),        # ranks 2 and 3 past the mesh
}


def jax_moe_state(pth):
    """JAX's upcycled MoE ViT (export.py:157-186: its routers' init from
    PRNGKey(0)) in the port's names, for the port's ranks to load."""
    bb = jget_backbone("vit-tiny-test", pth)
    cfg = dataclasses.replace(bb.module.config, moe_every_k=2, n_experts=4)
    init = bb.module.clone(config=cfg).init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 32, 32, 3)))["params"]
    return vit_state_dict_from_jax(upcycle_dense_to_moe(bb.variables["params"], init, cfg))


@pytest.fixture(scope="module")
def setup(tiny_pth, tmp_path_factory):  # noqa: F811
    out = str(tmp_path_factory.mktemp("mesh_programs"))
    frames = np.random.default_rng(0).integers(0, 256, (B, 32, 32, 3), np.uint8)
    base = dict(architecture="vit-tiny-test", model_path=tiny_pth, batch_size=B,
                input_resolution=32, compute_dtype="float32", device="cpu")
    programs = {name: dict(base, **flags) for name, flags in PROGRAMS.items()}
    export = spawn([dict(kind="export_mesh", name="export", programs=programs, dir=out,
                         frames=frames, moe_state=jax_moe_state(tiny_pth), main=("pp",))],
                   str(tmp_path_factory.mktemp("export_ranks")), WORLD, timeout=300)
    paths = {name: os.path.join(out, name.replace(" ", "_") + ".json") for name in PROGRAMS}
    load = spawn([dict(kind="load_mesh", name="load", paths=paths, frames=frames)],
                 str(tmp_path_factory.mktemp("load_ranks")), WORLD, timeout=300)
    return dict(export=[r["export"] for r in export], load=[r["load"] for r in load],
                frames=frames, paths=paths, base=base)


def joined(ranks, name):
    """The features of the mesh's ranks at inner index 0, in data order."""
    firsts = sorted((r[name]["coords"], r[name]["program"]) for r in ranks
                    if r[name] and r[name]["coords"][1] == 0)
    return torch.cat([t for _, t in firsts]).numpy()


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_mesh_program_matches_jax_artifact(setup, name):
    flags = PROGRAMS[name]
    blob, _, shape, mesh = jexport.export_features(
        "vit-tiny-test", setup["base"]["model_path"], B, 32, "float32", **flags)
    x = jax.device_put(jnp.asarray(setup["frames"]), NamedSharding(mesh, P("data")))
    want = np.asarray(jax.export.deserialize(bytearray(blob)).call(x))
    got = joined(setup["load"], name)
    assert got.shape == want.shape == (B, 16, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 if name == "ep" else 2e-5)
    # every rank of a data row returns its row's features; a rank past the
    # mesh loads nothing
    on = [r[name] for r in setup["load"] if r[name]]
    assert len(on) == mesh.devices.size
    b = B // flags.get("data_parallel", 1)
    for r in on:
        d = r["coords"][0]
        np.testing.assert_allclose(r["program"].numpy(), got[d * b:(d + 1) * b],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", [n for n in PROGRAMS if n != "pp"])
def test_each_rank_program_equals_its_live_mesh_forward(setup, name):
    for ex, ld in zip(setup["export"], setup["load"]):
        assert bool(ex[name]) == bool(ld[name])
        if ex[name]:
            assert ex[name]["coords"] == ld[name]["coords"]
            torch.testing.assert_close(ld[name]["program"], ex[name]["live"], rtol=0,
                                       atol=1e-6)


def test_main_checks_the_mesh_program_and_writes_the_manifest(setup):
    printed = [r["pp"] for r in setup["export"]]
    assert all(p["rc"] == 0 for p in printed)
    text = printed[0]["printed"]
    assert "2x2 pipe mesh" in text and "round-trip check: max|Δ| = 0.00e+00" in text, text
    assert not printed[1]["printed"]
    manifest = json.load(open(setup["paths"]["pp"]))
    assert manifest["kind"] == "pp" and manifest["world_size"] == WORLD
    assert manifest["axis_names"] == ["data", "pipe"] and manifest["axis_sizes"] == [2, 2]
    assert manifest["n_micro"] == 2 and manifest["batch"] == B
    for rank, entry in enumerate(manifest["ranks"]):
        assert entry["coords"] == [rank // 2, rank % 2]
        assert os.path.exists(texport.program_path(setup["paths"]["pp"], rank))


def test_loading_with_another_world_size_raises(setup):
    with pytest.raises(ValueError, match="4 ranks; the process group has 1"):
        texport.load_exported(setup["paths"]["tp"])
