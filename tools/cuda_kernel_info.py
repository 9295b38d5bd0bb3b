#!/usr/bin/env python3
"""What the compiler made of the port's CUDA kernels: registers, spills and
static shared memory of every kernel (``nvcc -Xptxas -v``), and how many
tensor-core, TMA and asynchronous-copy instructions its machine code holds
(``cuobjdump -sass``: HGMMA is ``wgmma``, UTMALDG a TMA tensor load, LDGSTS
``cp.async``, SYNCS an ``mbarrier`` operation).

    python tools/cuda_kernel_info.py [source.cu ...]

Without arguments: ``flash_attention.cu`` and ``mha.cu``. Needs the CUDA
toolkit (``nvcc``, ``cuobjdump``), no card. Prints ptxas's warnings too (a
``wgmma`` that it had to serialise shows up there).
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from timetuning_tpu_torch.ops import kernel_lib  # noqa: E402

SASS = ("HGMMA", "UTMALDG", "LDGSTS", "SYNCS")


def short(mangled: str) -> str:
    """``..._kernelILi208EE...`` -> ``mha_one_pass_kernel<208>``."""
    for m in re.finditer(r"\d+", mangled):       # Itanium: <length><name>
        name = mangled[m.end():m.end() + int(m.group())]
        if name.endswith("_kernel"):
            arg = re.match(r"ILi(\d+)E", mangled[m.end() + len(name):])
            return name + (f"<{arg.group(1)}>" if arg else "")
    return mangled


def main(argv: list[str]) -> int:
    names = argv or ["flash_attention.cu", "mha.cu"]
    nvcc = kernel_lib._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for name in names:
            obj = str(Path(tmp) / (Path(name).stem + ".o"))
            cmd = [nvcc, *kernel_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj,
                   str(kernel_lib.CSRC_DIR / name)]
            jobs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for name, obj, proc in jobs:
            out = proc.communicate()[0]
            if proc.returncode:
                print(out)
                return proc.returncode
            counts: dict[str, dict[str, int]] = {}
            sass = subprocess.run([cuobjdump, "-sass", obj], capture_output=True,
                                  text=True).stdout
            fn = ""
            for line in sass.splitlines():
                if "Function :" in line:
                    fn = short(line.split("Function :")[1].strip())
                    counts[fn] = dict.fromkeys(SASS, 0)
                for op in SASS:
                    if fn and re.search(rf"\b{op}\b|\b{op}\.", line):
                        counts[fn][op] += 1
            print(f"== {name}")
            fn = ""
            for line in out.splitlines():
                if "Compiling entry function" in line:
                    fn = short(line.split("'")[1])
                elif "bytes stack frame" in line:
                    spills = line.strip()
                elif "Used" in line and fn:
                    used = line.split(":", 1)[1].strip()
                    ops = ", ".join(f"{op} {n}" for op, n in counts.get(fn, {}).items())
                    print(f"{fn}: {used}; {spills}; {ops}")
                elif "warning" in line.lower():
                    print(f"  {line.strip()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
