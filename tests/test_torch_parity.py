"""The port's parity harness (timetuning_tpu_torch/cli/parity.py) against the
JAX package's on the same made-up TimeT.pth (the reference key layout at
``vit-tiny-test`` size) and the same synthetic DAVIS and Pascal VOC trees,
``--device cpu``. Stages 1-3 must give the same report rows within the
CLI's own tolerances (each row's ``tolerance``), and ``--report_json`` the
same schema; the k-means of stage 3 takes JAX's draws (mirrored keys). The
fixtures are copies of ``tests/test_parity_cli.py``'s."""

import json

import jax
import numpy as np
import pytest
import torch

from test_torch_kmeans import mirror_keys
from timetuning_tpu.cli import parity as jparity
from timetuning_tpu_torch.cli import parity as tparity
from timetuning_tpu_torch.eval import parity_oracle as toracle

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def timet_pth(tmp_path_factory):
    """A random-weight checkpoint with the TimeT.pth key contract, sized to
    vit-tiny-test, with a head and 8 prototypes."""
    torch.manual_seed(0)
    oracle = toracle.build_oracle(img_size=32, patch_size=8, dim=32, depth=2, heads=2)
    head = toracle.build_oracle_head((48, 24), 32)
    protos = torch.nn.functional.normalize(torch.randn(8, 24), dim=-1)
    sd = {f"feature_extractor.backbone.{k}": v for k, v in oracle.state_dict().items()}
    sd.update({f"feature_extractor.head.{k}": v for k, v in head.state_dict().items()})
    sd["prototypes"] = protos
    path = tmp_path_factory.mktemp("ckpt") / "TimeT.pth"
    torch.save(sd, str(path))
    return str(path)


@pytest.fixture(scope="module")
def davis_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("davis")
    for v in range(2):
        fdir = root / "JPEGImages" / "480p" / f"video{v}"
        adir = root / "Annotations" / "480p" / f"video{v}"
        fdir.mkdir(parents=True)
        adir.mkdir(parents=True)
        for f in range(6):
            img = np.full((64, 64, 3), 30, np.uint8)
            y = 16 + f
            img[y:y + 24, 20:44] = [220, 40, 40]
            cv2.imwrite(str(fdir / f"{f:05d}.jpg"), img)
            ann = np.zeros((64, 64), np.uint8)
            ann[y:y + 24, 20:44] = 1
            cv2.imwrite(str(adir / f"{f:05d}.png"), ann)
    return str(root)


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    for d in ("images", "SegmentationClass", "SegmentationClassAug", "sets"):
        (root / d).mkdir()
    rng = np.random.default_rng(0)
    names = [f"img{i}" for i in range(4)]
    for n in names:
        img = np.full((64, 64, 3), 40, np.uint8)
        mask = np.zeros((64, 64), np.uint8)
        y = int(rng.integers(8, 24))
        img[y:y + 24, 16:48] = [200, 60, 60]
        mask[y:y + 24, 16:48] = 1
        cv2.imwrite(str(root / "images" / f"{n}.jpg"), img[..., ::-1])
        cv2.imwrite(str(root / "SegmentationClass" / f"{n}.png"), mask)
        cv2.imwrite(str(root / "SegmentationClassAug" / f"{n}.png"), mask)
    (root / "sets" / "val.txt").write_text("\n".join(names))
    (root / "sets" / "trainaug.txt").write_text("\n".join(names))
    return str(root)


TINY = ["--architecture", "vit-tiny-test", "--input_resolution", "32"]


def _rows(path):
    with open(path) as f:
        return json.load(f)


def test_stages_1_to_3_match_jax(monkeypatch, timet_pth, davis_tree, voc_tree, tmp_path,
                                 capsys):
    argv = [*TINY, "--timet_pth", timet_pth, "--davis_root", davis_tree,
            "--pascal_root", voc_tree, "--num_frames", "4", "--n_last_frames", "2",
            "--size_mask_neighborhood", "2", "--pascal_clusters", "2",
            "--eval_resolution", "16", "--num_workers", "2"]
    assert jparity.main([*argv, "--report_json", str(tmp_path / "j.json")]) == 0
    mirror_keys(monkeypatch, [jax.random.PRNGKey(1)])
    assert tparity.main([*argv, "--device", "cpu",
                         "--report_json", str(tmp_path / "t.json")]) == 0
    out = capsys.readouterr().out
    want, got = _rows(tmp_path / "j.json"), _rows(tmp_path / "t.json")
    assert got["summary"] == want["summary"] and got["summary"]["ok"] is True
    assert [r["metric"] for r in got["rows"]] == [r["metric"] for r in want["rows"]]
    for g, w in zip(got["rows"], want["rows"]):
        assert set(g) == set(w) == {"metric", "value", "expected", "tolerance", "pass"}
        assert (g["expected"], g["tolerance"], g["pass"]) == (
            w["expected"], w["tolerance"], w["pass"]), g["metric"]
        assert abs(g["value"] - w["value"]) <= g["tolerance"], (g, w)
    j_row = next(r for r in got["rows"] if r["metric"].startswith("DAVIS J ("))
    assert j_row["value"] > 0.3          # the moving box is propagated
    assert "prototype scores max|Δ|" in out


def test_stage_4_and_a_failing_gate(timet_pth, voc_tree, tmp_path, capsys):
    """Prototype-argmax clustering runs; an impossible gate flips the exit
    code and the JSON verdict to failure, as JAX's CLI does."""
    rc = tparity.main([*TINY, "--timet_pth", timet_pth, "--device", "cpu",
                       "--pascal_root", voc_tree, "--pascal_clusters", "2",
                       "--eval_resolution", "16", "--proto_clustering", "true"])
    out = capsys.readouterr().out
    assert rc == 0, out
    row = next(ln for ln in out.splitlines() if ln.startswith("Pascal mIoU (prototype"))
    assert 0.0 <= float(row.split("ours=")[1].split()[0]) <= 1.0
    path = tmp_path / "fail.json"
    rc = tparity.main([*TINY, "--timet_pth", timet_pth, "--device", "cpu",
                       "--feature_atol", "0", "--report_json", str(path)])
    assert rc == 1 and "FAIL" in capsys.readouterr().out
    payload = _rows(path)
    assert payload["summary"]["ok"] is False
    assert any(r["pass"] is False for r in payload["rows"])


def test_plain_backbone_checkpoint(tmp_path, capsys):
    """A backbone-only release under a stripped prefix runs stage 1, and
    has no prototype row; the import rows agree with JAX's."""
    torch.manual_seed(1)
    oracle = toracle.build_oracle(img_size=32, patch_size=8, dim=32, depth=2, heads=2)
    path = tmp_path / "dino_small.pth"
    torch.save({f"teacher.backbone.{k}": v for k, v in oracle.state_dict().items()},
               str(path))
    argv = [*TINY, "--timet_pth", str(path)]
    assert jparity.main([*argv, "--report_json", str(tmp_path / "j.json")]) == 0
    assert tparity.main([*argv, "--device", "cpu",
                         "--report_json", str(tmp_path / "t.json")]) == 0
    out = capsys.readouterr().out
    assert "prototype scores" not in out
    got, want = _rows(tmp_path / "t.json")["rows"], _rows(tmp_path / "j.json")["rows"]
    assert [r["metric"] for r in got] == [r["metric"] for r in want]
    assert all(r["pass"] is True for r in got)



def test_extractor_and_head_match_the_oracle(timet_pth):
    """The port's backbone (through the registry's importer) and projection
    head (through ``import_torch`` + ``convert``), as parity's stage 1
    builds them, against the oracle ViT and ``build_oracle_head`` on the
    same state dict, at 1e-5 (stage 1 gates at 5e-3)."""
    from timetuning_tpu_torch.core.timet import TimeT
    from timetuning_tpu_torch.models.convert import timet_state_dict_from_jax
    from timetuning_tpu_torch.models.extractor import FeatureExtractor
    from timetuning_tpu_torch.models.import_torch import (
        load_torch_state_dict,
        timet_params_from_torch,
    )
    from timetuning_tpu_torch.models.registry import get_backbone

    sd = load_torch_state_dict(timet_pth)
    bb = get_backbone("vit-tiny-test", timet_pth, device="cpu")
    model = TimeT(FeatureExtractor(bb.module, bb.feature_dim, (48, 24)), 8)
    rest = {k: v for k, v in timet_state_dict_from_jax(timet_params_from_torch(sd)).items()
            if not k.startswith("feature_extractor.backbone.")}
    assert not model.load_state_dict(rest, strict=False).unexpected_keys
    oracle = toracle.oracle_from_state_dict(
        {k[len("feature_extractor.backbone."):]: torch.as_tensor(v) for k, v in sd.items()
         if k.startswith("feature_extractor.backbone.")}, 32, 2)
    head = toracle.build_oracle_head((48, 24), 32)
    head.load_state_dict({k[len("feature_extractor.head."):]: torch.as_tensor(v)
                          for k, v in sd.items() if k.startswith("feature_extractor.head.")})
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 3, 48, 48)).astype(np.float32))
    with torch.no_grad():
        want = head(oracle(x)[0][:, 1:])
        got, _ = model(x.permute(0, 2, 3, 1))
        plain, _ = model(x.permute(0, 2, 3, 1), use_head=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(plain, oracle(x)[0][:, 1:], rtol=1e-5, atol=1e-5)
