#!/usr/bin/env python3
"""What the compiler made of the port's CUDA kernels: registers, spills and
static shared memory of every kernel (``nvcc -Xptxas -v``), and how many
tensor-core, TMA and asynchronous-copy instructions its machine code holds
(``cuobjdump -sass``: HGMMA is ``wgmma``, UTMALDG a TMA tensor load, LDGSTS
``cp.async``, SYNCS an ``mbarrier`` operation).

    python tools/cuda_kernel_info.py [source.cu ...]

Without arguments: the sources that hold ``wgmma`` kernels, the two attention
cores (``flash_attention.cu``, ``mha.cu``), the three block sources built
on the GEMM tile of ``gemm_wgmma.cuh`` (``rows_block.cu``,
``attention_block.cu``, ``mlp_block.cu``; its kernels print as
``gemm_wgmma_kernel<LN prologue, 64-row groups, prologue chunks, epilogue>``,
``gemm_wide_kernel``, ``gemm_swiglu_kernel`` and
``gemm_swiglu_kernel_wide``) and the propagation kernel (``propagation.cu``:
``prop_rows_kernel<f32 split>``, ``prop_seg_kernel``), the eval preprocess
(``preprocess.cu``: ``preprocess_kernel<W taps bucket>``) and the Sinkhorn
(``sinkhorn.cu``: ``sinkhorn_kernel<rows a lane, scores entry, slab in
shared memory>``). Needs the CUDA
toolkit (``nvcc``, ``cuobjdump``), no card. Prints ptxas's warnings and its
"Potential Performance Loss" remarks too (a ``wgmma`` that it had to
serialise shows up as such a remark, C7510-C7520, under ``ptxas info``).
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
    """``..._kernelILi208EE...`` -> ``mha_one_pass_kernel<208>``;
    ``..._kernelILb1ELb0ELi2ELi0EE...`` -> ``gemm_wgmma_kernel<1,0,2,0>``."""
    # Itanium: <length><name>; a length may follow a hash that ends in a
    # digit, so every suffix of a run of digits is tried
    for m in re.finditer(r"(?=(\d+))", mangled):
        end = m.end(1)
        name = mangled[end:end + int(m.group(1))]
        if name.endswith(("_kernel", "_kernel_wide", "_kernel_windows")):
            args = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[end + len(name):])
            vals = re.findall(r"L[a-z](\d+)E", args.group(1)) if args else []
            return name + (f"<{','.join(vals)}>" if vals else "")
    return mangled


def main(argv: list[str]) -> int:
    names = argv or ["flash_attention.cu", "mha.cu", "rows_block.cu",
                     "attention_block.cu", "mlp_block.cu", "propagation.cu",
                     "preprocess.cu", "sinkhorn.cu"]
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
                elif "warning" in line.lower() or "Performance Loss" in line:
                    print(f"  {line.strip()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
