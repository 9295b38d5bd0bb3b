"""Nothing a run loads may be JAX or the JAX package: each driver's set-up
path imported in a fresh interpreter, and the top-level name of every
module in ``sys.modules`` (the part before the first dot, compared whole)
checked against jax, jaxlib, flax, optax and timetuning_tpu. The port,
timetuning_tpu_torch, passes."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import ROOT

from benchmark import harness

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import harness
harness.set_cache_dirs(harness.HERE.parent)
harness.load_module(harness.HERE / 'drivers' / ({entry!r} + '.py'), {entry!r})
import benchmark.run, benchmark.readings
from timetuning_tpu_torch.core import train
from timetuning_tpu_torch.cli import export
from timetuning_tpu_torch.data import loader
for m in list(harness.HERE.glob("metrics/*.py")):
    harness.load_module(m, m.stem)
print(json.dumps(sorted(sys.modules)))
"""


@pytest.mark.parametrize("entry", ["timet_train", "timet_train_dp", "serve_export"])
def test_driver_loads_no_jax(entry):
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), entry=entry)],
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".", 1)[0] for m in mods}
    assert "timetuning_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN_MODULES), sorted(tops & set(harness.FORBIDDEN_MODULES))


def test_forbidden_names_compare_whole():
    names = ["timetuning_tpu_torch", "timetuning_tpu_torch.ops", "jaxtyping", "numpy",
             "timetuning_tpu.core", "jax", "flax.linen", "optax"]
    assert harness.forbidden_modules(names) == ["flax.linen", "jax", "optax",
                                                "timetuning_tpu.core"]


def test_references_import_nothing_of_the_program():
    """The references read neither JAX, nor the JAX package, nor the port."""
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        src = path.read_text()
        for name in ("timetuning_tpu", "jax", "flax", "optax"):
            assert f"import {name}" not in src and f"from {name}" not in src, (path, name)


def test_rank_that_loads_the_jax_package_fails_the_run(tmp_path, monkeypatch):
    """A data-parallel rank other than 0 runs in a process of its own: a JAX
    package module planted there (by a ``sitecustomize`` on the ranks'
    path) makes that rank end non-zero and the run raise, with no result."""
    from conftest import tiny_run

    (tmp_path / "sitecustomize.py").write_text(
        "import sys, types\nsys.modules['timetuning_tpu'] = types.ModuleType('timetuning_tpu')\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="ranks ended with"):
        tiny_run("train_dp", seed=404, seconds=1.0)
