"""gsearch_tpu_torch sign-expansion searcher against gsearch_tpu's
MxuSearcher(approx=False): expansions bit-exact; with planted neighbours
the same ids in the same order and bit-exact rerank distances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsearch_tpu.ops import mxu as jmxu
from gsearch_tpu_torch.ops import distance as tdist
from gsearch_tpu_torch.ops import mxu as tmxu

CPU = torch.device("cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.uint32])
def test_expand_signs_bit_exact(rng, dtype):
    sigs = rng.integers(0, 1 << 31, size=(6, 40)).astype(np.uint32)
    if dtype == np.float32:
        sigs = rng.random((6, 40), dtype=np.float32)
    want = np.asarray(jmxu.expand_signs(jnp.asarray(sigs), m=4))
    got = tmxu.expand_signs(tdist.as_int32_rows(sigs), 4).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def _planted(rng, n, s, nq, per):
    """Random f32 signatures; each query has `per` planted neighbours at
    distinct distances (3 + 5j slots redrawn), so the top-k is unambiguous."""
    db = rng.random((n, s), dtype=np.float32)
    q = rng.random((nq, s), dtype=np.float32)
    for i in range(nq):
        for j in range(per):
            row = q[i].copy()
            pos = rng.choice(s, 3 + 5 * j, replace=False)
            row[pos] = rng.random(len(pos), dtype=np.float32)
            db[rng.integers(n)] = row
    return db, q


@pytest.mark.parametrize("n", [4096, 5003])
def test_mxu_searcher_matches_reference(rng, n):
    s, k = 256, 10
    db, q = _planted(rng, n, s, nq=12, per=12)
    want_d, want_i = jmxu.MxuSearcher(db, m=4, rerank_factor=8, approx=False).search(q, k)
    got_d, got_i = tmxu.MxuSearcher(db, CPU).search(q, k)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d.view(np.uint32), want_d.view(np.uint32))
    # and it is the exact top-k
    ex_d, ex_i = tdist.bucketed_knn(torch.from_numpy(q), torch.from_numpy(db), k)
    np.testing.assert_array_equal(got_i, ex_i)


def test_mxu_searcher_int_and_query_chunks(rng, monkeypatch):
    """u32 signatures, and more queries than one score chunk holds."""
    monkeypatch.setattr(tmxu, "_SCORE_ELEMS", 64 * 8)
    sigs = rng.integers(0, 1 << 20, size=(300, 64)).astype(np.uint32)
    d, ids = tmxu.MxuSearcher(sigs, CPU).search(sigs[:70], 5)
    assert ids.shape == (70, 5) and (ids[:, 0] == np.arange(70)).all()
    assert (d[:, 0] == 0.0).all()
    want_d, want_i = jmxu.MxuSearcher(sigs, approx=False).search(sigs[:70], 5)
    np.testing.assert_array_equal(ids[:, 0], want_i[:, 0])
    np.testing.assert_array_equal(d.view(np.uint32)[:, 0], want_d.view(np.uint32)[:, 0])


def test_mxu_distance_ties_ordered_by_id(rng):
    """Rows that differ from a query in equally many slots (at different
    positions, so with different sign-dot scores) tie in distance; ties come
    back by lower id, as from the exact sweep, so both routes of the flat
    index write the same neighbours file."""
    s, n = 128, 4200
    q = rng.random((4, s), dtype=np.float32)
    db = rng.random((n, s), dtype=np.float32)
    for row in rng.choice(n, size=60, replace=False):
        x = q[row % 4].copy()
        pos = rng.choice(s, 8 * (1 + row % 3), replace=False)
        x[pos] = rng.random(len(pos), dtype=np.float32)
        db[row] = x
    d, ids = tmxu.MxuSearcher(db, CPU).search(q, 10)
    ex_d, ex_i = tdist.bucketed_knn(torch.from_numpy(q), torch.from_numpy(db), 10)
    assert (np.diff(ex_d, axis=1) == 0).any()  # the case has ties
    np.testing.assert_array_equal(ids, ex_i)
    np.testing.assert_array_equal(d.view(np.uint32), ex_d.view(np.uint32))
