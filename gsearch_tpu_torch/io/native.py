"""ctypes bindings for the native FASTA parser (csrc/fastaparse.cpp).

The library is built at first use with `g++ -O3 -march=native -shared
-fPIC` into `build/gsearch_tpu_torch/` beside the package (a directory
.gitignore lists), named by a digest of the source and flags, and loaded
with ctypes.  Where it cannot be built (no C++ compiler), every caller
takes the pure-Python parser of io/fasta.py, which gives the same codes:
this is host parsing, not a device kernel.  `parser()` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..utils import get_logger
from .codec import PackedCodes

log = get_logger(__name__)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "fastaparse.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "gsearch_tpu_torch")
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_ID_CAP = 512
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfastaparse_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the parser unless this exact build exists; returns its path.
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
    u8p, szp = c.POINTER(c.c_uint8), c.POINTER(c.c_size_t)
    lib.fasta_concat_codes.restype = c.c_long
    lib.fasta_concat_codes.argtypes = [
        c.c_char_p, c.c_size_t, u8p, c.c_size_t, c.c_int, c.c_long,
        szp, c.c_char_p, c.c_size_t, szp]
    lib.fasta_records_codes.restype = c.c_long
    lib.fasta_records_codes.argtypes = [
        c.c_char_p, c.c_size_t, u8p, c.c_size_t, c.c_int, c.c_long,
        szp, szp, c.c_long, c.c_char_p, c.c_size_t, szp]
    lib.fasta_concat_pack2.restype = c.c_long
    lib.fasta_concat_pack2.argtypes = [
        c.c_char_p, c.c_size_t, u8p, c.c_size_t, c.POINTER(c.c_int32), c.c_long,
        c.c_long, szp, c.c_char_p, c.c_size_t, szp, c.POINTER(c.c_long)]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded parser, built on first call; None where it cannot be built."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _load(build())
            except (RuntimeError, OSError, subprocess.SubprocessError) as e:
                log.warning("native FASTA parser unavailable, parsing in Python: %s", e)
        return _lib


def parser() -> str:
    """"native" or "python": the parser io/fasta.py runs in this process."""
    return "native" if get_lib() is not None else "python"


def native_concat_codes(
    data: bytes, is_aa: bool, min_seq_size: int
) -> Optional[Tuple[np.ndarray, str, int]]:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(len(data) + 1, dtype=np.uint8)
    out_len = ctypes.c_size_t(0)
    total = ctypes.c_size_t(0)
    first_id = ctypes.create_string_buffer(_ID_CAP)
    kept = lib.fasta_concat_codes(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size,
        1 if is_aa else 0, min_seq_size,
        ctypes.byref(out_len), first_id, _ID_CAP,
        ctypes.byref(total),
    )
    if kept < 0:
        return None
    return out[: out_len.value], first_id.value.decode("utf-8", "replace"), int(total.value)


def native_records_codes(
    data: bytes, is_aa: bool, min_seq_size: int, max_records: int = 1 << 20
) -> Optional[List[Tuple[np.ndarray, str]]]:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(len(data) + 1, dtype=np.uint8)
    offsets = np.zeros(max_records, dtype=np.uintp)
    lengths = np.zeros(max_records, dtype=np.uintp)
    ids = ctypes.create_string_buffer(max_records * 64)
    out_len = ctypes.c_size_t(0)
    kept = lib.fasta_records_codes(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size,
        1 if is_aa else 0, min_seq_size,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)),
        max_records, ids, 64,
        ctypes.byref(out_len),
    )
    if kept < 0:
        return None
    raw = ids.raw
    result = []
    for i in range(kept):
        o, n = int(offsets[i]), int(lengths[i])
        ident = raw[i * 64 : (i + 1) * 64].split(b"\0", 1)[0].decode("utf-8", "replace")
        result.append((out[o : o + n], ident))
    return result


def native_concat_pack2(data: bytes, min_seq_size: int):
    """Fused one-block parse and 2-bit pack (DNA): FASTA bytes ->
    (PackedCodes, first fasta id, residues), or None when the parser is not
    built or the file holds more invalid positions than the packed form's
    budget (N-run-heavy; the caller takes the unfused path)."""
    lib = get_lib()
    if lib is None:
        return None
    cap = len(data) // 4 + 2
    p2 = np.empty(cap, dtype=np.uint8)
    max_exc = max(4096, len(data) // 16)
    inv = np.empty(max_exc, dtype=np.int32)
    out_codes = ctypes.c_size_t(0)
    total = ctypes.c_size_t(0)
    ninv = ctypes.c_long(0)
    first_id = ctypes.create_string_buffer(_ID_CAP)
    kept = lib.fasta_concat_pack2(
        data, len(data),
        p2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        inv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_exc,
        min_seq_size,
        ctypes.byref(out_codes), first_id, _ID_CAP,
        ctypes.byref(total), ctypes.byref(ninv),
    )
    if kept < 0:
        return None
    if kept == 0:
        return PackedCodes(np.empty(0, np.uint8), 0, np.empty(0, np.int32)), "", 0
    return (
        PackedCodes(p2, int(out_codes.value), inv[: ninv.value].copy()),
        first_id.value.decode("utf-8", "replace"),
        int(total.value),
    )
