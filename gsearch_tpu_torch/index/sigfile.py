"""The signature matrix of a database, `index.sigs.npy`, for both index kinds.

The file is a plain C-order 2-D .npy [N, S] (f32, u32 or u16 signatures), as
gsearch_tpu writes it.  The reader uses numpy's public header API (the
reference's `io/npyio.py` calls `np.lib.format._read_array_header`, which
newer numpy releases lack) and can read straight into a capacity buffer
with append headroom, so the graph index's first `add` after a reload does
not copy the matrix again.
"""

from __future__ import annotations

import numpy as np

SIGS_SUFFIX = ".sigs.npy"


def save_sigs(prefix: str, sigs: np.ndarray) -> None:
    np.save(prefix + SIGS_SUFFIX, sigs)


def load_sigs(prefix: str, headroom: bool = False):
    """Read prefix + ".sigs.npy" in one disk read.  Returns (buf, n) with
    buf[:n] the live rows; with headroom, buf has ~12.5% (at least 4096)
    spare rows for appends, else exactly n rows."""
    path = prefix + SIGS_SUFFIX
    fmt = np.lib.format
    with open(path, "rb") as f:
        version = fmt.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = fmt.read_array_header_1_0(f)
        elif version == (2, 0):
            shape, fortran, dtype = fmt.read_array_header_2_0(f)
        else:
            raise ValueError(f"{path}: unsupported .npy version {version}")
        if len(shape) != 2 or fortran or dtype.hasobject:
            raise ValueError(f"{path}: expected a C-order 2-D numeric array, got {shape} {dtype}")
        n, s = shape
        buf = np.empty((n + (max(n >> 3, 4096) if headroom else 0), s), dtype)
        live = buf[:n].reshape(-1).view(np.uint8)
        if f.readinto(live) != live.nbytes:
            raise ValueError(f"{path}: truncated payload")
    return buf, n
