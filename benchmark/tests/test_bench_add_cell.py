"""A cell is added as data: in a copy of the manifest and the benchmark's
folder, a new configuration, traffic mix, limits and ``BENCHMARK.json``
entry are found by name, with no existing file edited."""

from __future__ import annotations

import hashlib
import json
import shutil

from conftest import ROOT

from benchmark import harness


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "benchmark")
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "dino-s16-224.json").read_text())
    cfg.update(name="dino-b16-224", embed_dim=768, num_heads=12, architecture="dino-b16")
    (bench / "configs" / "dino-b16-224.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "frames-448-c25.json").read_text())
    traffic.update(frames=64, height=224, width=224)
    (bench / "traffic" / "frames-224-b64.json").write_text(json.dumps(traffic))
    (bench / "limits" / "serve-b16-b64.json").write_text(json.dumps({"limits": {"token_gap": 1}}))
    assert _digests(bench).items() >= before.items()

    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "dino-b16-224", "source": "https://github.com/facebookresearch/dino",
                         "file": "benchmark/configs/dino-b16-224.json",
                         "reduced": ["pretrained_weights"], "why": "ViT-B/16"})
    m["workloads"].append({"name": "serve-b16-b64", "config": "dino-b16-224",
                           "traffic": "frames-224-b64", "chips": 1, "why": "ViT-B serving"})
    for e in m["end_to_end"]:
        if e["name"] in ("frames_per_s", "request_ms_p95"):
            e["workloads"].append("serve-b16-b64")
    for p in m["per_layer"]:
        if p["name"].endswith(".dense"):
            p["workloads"].append("serve-b16-b64")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    cell = harness.load_cell(tmp_path, "serve-b16-b64")
    assert cell.config["embed_dim"] == 768 and cell.traffic["frames"] == 64
    assert {e["name"] for e in cell.end_to_end} == {"frames_per_s", "request_ms_p95", "setup_s"}
    assert {p["name"] for p in cell.per_layer} == {
        "mfu.dense", "block_roofline.dense", "idle_share.dense"}
    assert harness.load_driver(cell).run
    old = harness.load_cell(tmp_path, "serve-s8-c25")
    assert old.config["patch_size"] == 8
