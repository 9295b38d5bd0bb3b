"""BENCHMARK.json against the contract it is held to: names, units, keys,
limits of size, and every file it names present."""

from __future__ import annotations

import json
import re

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes():
    m = manifest()
    assert set(m) == KEYS["top"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(m["paths"]) <= 16 and all(PATH.match(p) for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32 and all(_line(w) for w in m["command"])
    assert all(not w.startswith("/") and ".." not in w for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    for c in m["configs"]:
        assert set(c) == KEYS["config"]
    for w in m["workloads"]:
        assert set(w) == KEYS["workload"] and w["chips"] in (1, 4) and _line(w["why"])
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == KEYS["e2e"]
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == KEYS["layer"]


def test_names_units_and_uniqueness():
    m = manifest()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in m[group]]
        assert len(set(names)) == len(names), group
        assert all(NAME.match(n) for n in names), names
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for c in m["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert _line(c["source"]) and _line(c["why"])


def test_metrics_and_moves():
    """setup_s is there; each per-layer metric moves an end-to-end metric
    that every cell it lists reports; every cell reports setup_s, another
    end-to-end metric and a per-layer one."""
    m = manifest()
    cells = {w["name"] for w in m["workloads"]}
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for p in m["per_layer"]:
        assert p["moves"] in e2e and _line(p["layer"])
        assert p["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(p.get("workloads", cells)) <= cells
        reports = set(e2e[p["moves"]].get("workloads", cells))
        assert set(p.get("workloads", cells)) <= reports, p["name"]
    layers: dict = {}
    for p in m["per_layer"]:
        layers.setdefault(p["name"].split(".")[0], set()).add(p["layer"])
    for cell in cells:
        mine = [e for e in m["end_to_end"] if cell in e.get("workloads", cells)]
        assert "setup_s" in {e["name"] for e in mine} and len(mine) >= 2
        assert any(cell in p.get("workloads", cells) for p in m["per_layer"])


def test_roofline_and_mfu_names():
    m = manifest()
    for p in m["per_layer"]:
        if "roofline" in p["name"] or "mfu" in p["name"]:
            assert p["unit"] == "%"
    moved = {p["moves"] for p in m["per_layer"] if "roofline" in p["name"]}
    assert moved <= {p["moves"] for p in m["per_layer"] if "mfu" in p["name"]}


def test_files_it_names():
    """Every configuration, traffic mix, driver, reader and limit is a file
    under the benchmark's own folder, found by name."""
    m = manifest()
    bench = ROOT / m["paths"][0]
    assert m["command"][1].startswith(m["paths"][0] + "/")
    for c in m["configs"]:
        assert c["file"].startswith(m["paths"][0] + "/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in m["workloads"]:
        traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
        assert (bench / "drivers" / f"{traffic['entry']}.py").exists()
        assert json.loads((bench / "limits" / f"{w['name']}.json").read_text())["limits"]
    for p in m["per_layer"]:
        assert (bench / "metrics" / f"{p['name']}.py").exists()


def test_run_budget():
    """A full check of 24 cells at this window fits the driver's 43,200 s."""
    secs = manifest()["run_seconds"]
    assert (2 + 14 * 24) * (secs + 60) + 24 * 180 + 1200 <= 43200


def test_four_chip_share():
    w = manifest()["workloads"]
    assert sum(x["chips"] == 4 for x in w) <= max(1, len(w) // 4)
