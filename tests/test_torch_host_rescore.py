"""The graph index's native host re-score (ops/host_rescore.py,
csrc/rescore.cpp) against the numpy form it replaces: the same equal-slot
counts and, through `HnswIndex._host_distances`, the same distances bit for
bit, for every signature dtype, ids past n, the candidate widths the tiers
fetch and one thread or the rule's count; and the numpy form taken, with
the same arrays, when the library cannot be built."""

import os

import numpy as np
import pytest
import torch

import gsearch_tpu_torch.index.hnsw as thnsw
from gsearch_tpu_torch.ops import host_rescore
from gsearch_tpu_torch.ops.distance import sig_bits

CPU = torch.device("cpu")
S = 96
N = 300


def _rows(rng, dtype, n):
    """n x S signatures of dtype whose rows share many slots, with f32's
    NaN payloads, -0.0 and +0.0 and u16's values >= 2^15 planted."""
    if dtype == np.uint16:
        base = rng.integers(0, 1 << 16, size=(8, S)).astype(np.uint16)
        base[:, :16] = rng.integers(1 << 15, 1 << 16, size=(8, 16))
    else:
        base = rng.integers(0, 1 << 32, size=(8, S), dtype=np.uint64).astype(np.uint32)
        if dtype == np.float32:
            # quiet and signalling NaNs with payloads, -0.0, +0.0
            base[:, :6] = [0x7FC00001, 0x7F800002, 0xFFC12345, 0x80000000, 0x00000000, 0x7FC00000]
        base = base.view(dtype)
    rows = base[rng.integers(0, 8, size=n)]
    redraw = rng.random(rows.shape) < 0.3
    rows[redraw] = base[rng.integers(0, 8, size=int(redraw.sum())), rng.integers(0, S, size=int(redraw.sum()))]
    return np.ascontiguousarray(rows)


def _numpy_counts(sigs, queries, ids):
    n = sigs.shape[0]
    return (sig_bits(sigs[np.clip(ids, 0, n - 1)]) == sig_bits(queries)[:, None, :]).sum(-1)


def _index(sigs):
    idx = thnsw.HnswIndex(S, sigs.dtype.type, device=CPU)
    idx._append_sigs(sigs)
    return idx


def _numpy_distances(sigs, queries, ids):
    """The reference's numpy form of `_host_distances`."""
    d = (1.0 - _numpy_counts(sigs, queries, ids) / np.float32(S)).astype(np.float32)
    d[ids >= sigs.shape[0]] = np.inf
    return d


@pytest.mark.parametrize("threads", [1, None], ids=["one-thread", "rule"])
@pytest.mark.parametrize("nq", [1, 1024])
@pytest.mark.parametrize("r", [10, 32, 160])
@pytest.mark.parametrize("dtype", [np.float32, np.uint32, np.int32, np.uint16],
                         ids=["f32", "u32", "i32", "u16"])
def test_native_counts_match_numpy(dtype, r, nq, threads):
    rng = np.random.default_rng([r, nq, np.dtype(dtype).num])
    sigs = _rows(rng, dtype, N + nq)
    db, queries = sigs[:N], sigs[N:]
    # ids past n, as a tier's pad rows give: the first of every query's is one
    ids = rng.integers(0, N + 40, size=(nq, r))
    ids[:, 0] = N + 7
    got = host_rescore.eq_counts(db, queries, ids, threads=threads)
    assert got is not None and got.dtype == np.int32
    np.testing.assert_array_equal(got, _numpy_counts(db, queries, ids))
    if threads is None:
        assert host_rescore.threads_for(ids.size) == max(1, min(
            len(os.sched_getaffinity(0)), ids.size // host_rescore.MIN_ROWS_PER_THREAD))
    d = _index(db)._host_distances(queries, ids)
    want = _numpy_distances(db, queries, ids)
    assert np.isinf(d[:, 0]).all()
    np.testing.assert_array_equal(d.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("threads", [2, 3, 7, 100_000])
def test_thread_split_gives_the_same_counts(threads):
    """Uneven splits, and more threads asked than pairs, count every pair
    once; a request of 8 genomes at k = 10 stays on one thread."""
    assert host_rescore.threads_for(80) == 1
    rng = np.random.default_rng(threads)
    sigs = _rows(rng, np.uint32, N + 50)
    ids = rng.integers(0, N, size=(50, 33))
    got = host_rescore.eq_counts(sigs[:N], sigs[N:], ids, threads=threads)
    np.testing.assert_array_equal(got, _numpy_counts(sigs[:N], sigs[N:], ids))


def test_strided_rows_are_read_in_place():
    """A row slice of a wider buffer (the capacity buffer's live rows are a
    prefix; a column slice is not a layout the library reads)."""
    rng = np.random.default_rng(3)
    buf = _rows(rng, np.float32, N + 20)
    ids = rng.integers(0, N, size=(20, 10))
    np.testing.assert_array_equal(host_rescore.eq_counts(buf[:N], buf[N:], ids),
                                  _numpy_counts(buf[:N], buf[N:], ids))
    assert host_rescore.eq_counts(buf[:N, : S // 2], buf[N:, : S // 2], ids) is not None
    assert host_rescore.eq_counts(buf[:N, ::2], np.ascontiguousarray(buf[N:, ::2]), ids) is None


@pytest.mark.parametrize("dtype", [np.float32, np.uint16], ids=["f32", "u16"])
def test_fallback_when_the_library_cannot_be_built(monkeypatch, dtype):
    rng = np.random.default_rng(11)
    sigs = _rows(rng, dtype, N + 64)
    db, queries = sigs[:N], sigs[N:]
    ids = rng.integers(0, N + 10, size=(64, 32))
    idx = _index(db)
    native = idx._host_distances(queries, ids)
    assert host_rescore.get_lib() is not None

    def no_compiler():
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH")

    monkeypatch.setattr(host_rescore, "build", no_compiler)
    monkeypatch.setattr(host_rescore, "_tried", False)
    monkeypatch.setattr(host_rescore, "_lib", None)
    assert host_rescore.eq_counts(db, queries, ids) is None
    assert host_rescore.get_lib() is None
    fallback = idx._host_distances(queries, ids)
    np.testing.assert_array_equal(fallback.view(np.uint32), native.view(np.uint32))
    np.testing.assert_array_equal(fallback.view(np.uint32),
                                  _numpy_distances(db, queries, ids).view(np.uint32))
