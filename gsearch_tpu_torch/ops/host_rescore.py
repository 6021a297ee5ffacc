"""ctypes bindings for the host re-score's equal-slot counts
(csrc/rescore.cpp).

`eq_counts(sigs, queries, ids)` gives, for each query and each of its
candidate ids (clipped to [0, n - 1]), the number of slots where the row
equals the query: 4-byte signatures compared as bit patterns, u16 as u16,
as `ops.distance.sig_bits` views them.  The library is built at first use
with `g++ -O3 -shared -fPIC` into `build/gsearch_tpu_torch/` beside the
package (a directory .gitignore lists), named by a digest of the source and
flags, and loaded with ctypes, whose calls release the GIL.  Where it cannot
be built or loaded (no C++ compiler), `eq_counts` returns None and the caller
counts in numpy, which gives the same counts.

The pairs are split over as many threads as the process may run on, but
never fewer than MIN_ROWS_PER_THREAD rows a thread, so a request of a few
genomes stays on the calling thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

from ..utils import get_logger

log = get_logger(__name__)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "rescore.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "gsearch_tpu_torch")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
#: rows a thread counts at least; below it a thread costs more than it saves
MIN_ROWS_PER_THREAD = 64
#: signature dtypes and the width their slots are compared at
_WIDTH = {np.dtype(np.float32): 4, np.dtype(np.int32): 4, np.dtype(np.uint32): 4,
          np.dtype(np.uint16): 2}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"librescore_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless this exact build exists; returns its path.
    Raises RuntimeError when there is no compiler or the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    c = ctypes
    lib.rescore_eq_counts.restype = c.c_int
    lib.rescore_eq_counts.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64, c.c_int64, c.c_int, c.c_void_p,
        c.POINTER(c.c_int64), c.c_int64, c.c_int64, c.POINTER(c.c_int32), c.c_int]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first call; None where it cannot be built."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _load(build())
            except (RuntimeError, OSError, subprocess.SubprocessError) as e:
                log.warning("native host re-score unavailable, counting in numpy: %s", e)
        return _lib


def threads_for(rows: int) -> int:
    """Threads for a call over `rows` candidate rows: the CPUs this process
    may run on, at least MIN_ROWS_PER_THREAD rows each."""
    try:
        cpus = len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity call on this platform
        cpus = os.cpu_count() or 1
    return max(1, min(cpus, rows // MIN_ROWS_PER_THREAD))


def eq_counts(sigs: np.ndarray, queries: np.ndarray, ids: np.ndarray,
              threads: Optional[int] = None) -> Optional[np.ndarray]:
    """Equal-slot counts [Q, R] int32 of queries [Q, S] against the rows
    sigs[clip(ids, 0, n - 1)] for ids [Q, R]; None where the library is not
    loaded or the arrays are not a layout it reads (the caller counts in
    numpy).  `threads` defaults to `threads_for(ids.size)`."""
    width = _WIDTH.get(sigs.dtype)
    n, s = sigs.shape
    if (width is None or queries.dtype != sigs.dtype or n == 0
            or sigs.strides[1] != width or sigs.strides[0] < 0 or sigs.strides[0] % width
            or queries.shape[1] != s or ids.shape[0] != queries.shape[0]):
        return None
    lib = get_lib()
    if lib is None:
        return None
    queries = np.ascontiguousarray(queries)
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    q, r = ids.shape
    out = np.empty((q, r), np.int32)
    rc = lib.rescore_eq_counts(
        sigs.ctypes.data, n, s, sigs.strides[0] // width, width, queries.ctypes.data,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), q, r,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        threads_for(ids.size) if threads is None else threads)
    return out if rc == 0 else None
