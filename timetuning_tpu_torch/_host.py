"""Import the JAX package's framework-free host modules without JAX.

``timetuning_tpu/data/loader.py``, ``data/datasets.py`` and
``models/export_torch.py`` import no jax themselves, but their packages'
``__init__`` files do (``timetuning_tpu/data/__init__.py`` imports
``transforms``, ``models/__init__.py`` imports ``vit``). When such a package
is not imported yet, this loads the module from its file under its own name,
without running the package ``__init__``; a later ``from
timetuning_tpu.data.datasets import ...`` inside the module then finds it in
``sys.modules``. Where the package is already imported (a process that runs
both packages, such as the tests), the ordinary import is used.
"""

from __future__ import annotations

import importlib
import importlib.util
import sys
from pathlib import Path
from types import ModuleType


def host_module(name: str) -> ModuleType:
    """``host_module("data.loader")`` -> ``timetuning_tpu.data.loader``."""
    full = f"timetuning_tpu.{name}"
    if full in sys.modules:
        return sys.modules[full]
    parent = full.rpartition(".")[0]
    if parent in sys.modules:
        return importlib.import_module(full)
    spec = importlib.util.find_spec("timetuning_tpu")
    path = Path(spec.origin).parent.joinpath(*name.split(".")).with_suffix(".py")
    mod_spec = importlib.util.spec_from_file_location(full, path)
    module = importlib.util.module_from_spec(mod_spec)
    sys.modules[full] = module
    try:
        mod_spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[full]
        raise
    return module
