"""Build and load the hand-written CUDA kernels (gsearch_tpu_torch/csrc).

The sources are compiled at first use, one `nvcc -gencode
arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c` a source,
all started together, and linked with `-shared` into one library under
`build/gsearch_tpu_torch/` beside the package (a directory .gitignore
lists), named by a digest of the sources and flags so an edited source is
rebuilt, and loaded with ctypes.  Nothing is built or loaded at import:
the CPU tests import every module.

`launches` counts kernel launches by wrapper name; each wrapper adds one
where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "gsearch_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

launches = {"hamming_frac": 0, "hamming_frac_self": 0, "gather_hamming": 0, "gather_hamming_p2": 0,
            "gather_hamming_p4": 0, "gather_hamming_p8": 0, "int_mm": 0, "viterbi": 0,
            "genepred_decode": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(a CUDA tensor needs them; CPU tensors take the plain path)")


def library_path() -> str:
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgsearch_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless this exact build exists; returns its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs, procs = [], []
    for src in sources:
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [_nvcc(), *compile_flags, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    try:
        for cmd, proc in procs:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        tmp = f"{out}.{tag}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        for cmd, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return out


def bind(path: str) -> ctypes.CDLL:
    """A build of csrc/*.cu loaded, with the C functions' argument types."""
    lib = ctypes.CDLL(path)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.gs_hamming_frac.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, vp]
    lib.gs_hamming_frac.restype = i
    lib.gs_gather_hamming.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, i, vp, vp, i, vp]
    lib.gs_gather_hamming.restype = i
    lib.gs_viterbi.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, vp]
    lib.gs_viterbi.restype = i
    f = ctypes.c_float
    lib.gs_genepred_decode.argtypes = [vp] * 8 + [f] * 5 + [vp] * 4 + [i, i, i, vp]
    lib.gs_genepred_decode.restype = i
    lib.gs_error_string.argtypes = [i]
    lib.gs_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


def current_stream(device) -> int:
    """The handle of torch's current CUDA stream on `device`, for a launch.
    The raw query: torch.cuda.current_stream() builds a Stream object, a
    third of a small launch's host time."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.gs_error_string(rc).decode("utf-8", "replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
