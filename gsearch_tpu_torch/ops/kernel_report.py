"""What nvcc made of the hand-written kernels of csrc/hamming.cu.

Run on a machine with the CUDA toolkit:
    python -m gsearch_tpu_torch.ops.kernel_report ["eqcount_kernel<16, 8, 4, true>"]
It compiles the sources with the build's flags plus `-Xptxas -v` into a
scratch library under build/gsearch_tpu_torch/ and prints
  - each kernel's registers, shared memory and spills (ptxas -v);
  - for each K1 kernel (`eqcount_kernel<WQ, WN, STAGES, VEC>`), the SASS
    instruction mix from `cuobjdump -sass`, and the instructions one
    32-bit slot compare costs in its unrolled compare loop: every
    compare-and-count of a chunk is unrolled (32 slots x 4 x 8 pairs a
    thread = 1,024 compares), so the ISETP, add and LDS counts of the
    kernel over 1,024 are the per-compare cost, plus the prologue and
    epilogue, which are small beside them.
Given a kernel's name, it also prints that kernel's SASS from its first
LDS.128 on: the compare loop.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys

from . import cuda_lib

_COMPARES_PER_CHUNK = 32 * 4 * 8


def _cuobjdump() -> str:
    return os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")


def compile_verbose() -> tuple:
    """(path of the scratch library, ptxas -v output)."""
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    out = os.path.join(cuda_lib.BUILD_DIR, "kernel_report.so")
    sources = sorted(p for p in os.listdir(cuda_lib.CSRC_DIR) if p.endswith(".cu"))
    cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
           *(os.path.join(cuda_lib.CSRC_DIR, p) for p in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return out, proc.stdout + proc.stderr


def sass_mix(lib: str) -> dict:
    """{kernel name: Counter of SASS opcodes} for every kernel in lib."""
    text = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    mix: dict = {}
    current = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = mix.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and current is not None:
            current[m.group(2)] += 1
    return mix


def _demangle(names) -> dict:
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True).stdout.splitlines()
        return dict(zip(names, out))
    except (OSError, subprocess.CalledProcessError):
        return {n: n for n in names}


def sass_window(lib: str, kernel: str, start_op: str = "LDS.128", count: int = 80) -> list:
    """`count` SASS lines of the first kernel whose demangled name holds
    `kernel`, from its first `start_op` on (the compare loop)."""
    text = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    blocks = re.split(r"\n\s*Function : ", text)
    names = _demangle([b.split("\n", 1)[0].strip() for b in blocks[1:]])
    for block in blocks[1:]:
        if kernel in names[block.split("\n", 1)[0].strip()]:
            lines = [ln.strip() for ln in block.splitlines() if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]
            first = next((i for i, ln in enumerate(lines) if start_op in ln), 0)
            return lines[first : first + count]
    return []


def main() -> int:
    lib, ptxas = compile_verbose()
    print("ptxas -v:")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())
    mix = sass_mix(lib)
    names = _demangle(list(mix))
    for mangled, ops in sorted(mix.items(), key=lambda kv: names[kv[0]]):
        name = names[mangled]
        if "eqcount_kernel" not in name:
            continue
        isetp = sum(v for k, v in ops.items() if k.startswith("ISETP"))
        adds = sum(v for k, v in ops.items() if k.startswith(("IADD", "IMAD.IADD", "VIADD")))
        lds = sum(v for k, v in ops.items() if k.startswith("LDS"))
        total = sum(ops.values())
        per = _COMPARES_PER_CHUNK
        print(f"{name}: {total} SASS instructions; per slot compare of the unrolled chunk: "
              f"ISETP {isetp / per:.3f}, integer adds {adds / per:.3f}, LDS {lds / per:.4f}, "
              f"all {total / per:.3f}")
        print("  " + ", ".join(f"{k} {v}" for k, v in ops.most_common(14)))
    if len(sys.argv) > 1:  # a kernel name: print its compare loop
        print("\n".join(sass_window(lib, sys.argv[1])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
