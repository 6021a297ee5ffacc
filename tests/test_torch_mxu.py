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


@pytest.mark.parametrize("rerank_cap", [None, 24 * 128])
@pytest.mark.parametrize("tier", ["full", "compact"])
def test_mxu_searcher_one_rerank_launch_over_the_chunks(rng, monkeypatch, tier, rerank_cap):
    """With _SCORE_ELEMS small, a batch spans several score chunks: the
    candidates of all chunks go through one K2 call and one top-k (or one
    a rerank batch, with _RERANK_ELEMS small too), and the results equal
    gsearch_tpu's MxuSearcher on the CPU: ids equal, distances bit-exact
    (full tier) or within an ulp (compact tier, whose reference divides by
    a constant through XLA's reciprocal)."""
    n, s, k, nq = (4096, 256, 10, 45) if tier == "full" else (3000, 1024, 10, 45)
    db = rng.random((n, s), dtype=np.float32)
    q = rng.random((nq, s), dtype=np.float32)
    # 12 planted neighbours a query at distinct distances, in distinct rows,
    # so no query's top-k holds a tie
    for i, rows in enumerate(rng.choice(n, size=(nq, 12), replace=False)):
        for j, row in enumerate(rows):
            db[row] = q[i]
            pos = rng.choice(s, 3 + 5 * j, replace=False)
            db[row, pos] = rng.random(len(pos), dtype=np.float32)
    monkeypatch.setattr(tmxu, "_SCORE_ELEMS", 16 * n)  # chunks of 32 queries
    if rerank_cap:
        monkeypatch.setattr(tmxu, "_RERANK_ELEMS", rerank_cap)
    calls = []

    def counted(*a, **kw):
        calls.append(a[2].shape)
        return tdist.gather_hamming(*a, **kw)

    monkeypatch.setattr(tmxu, "gather_hamming", counted)
    got = tmxu.MxuSearcher(db, CPU, compact=tier == "compact")
    d, ids = got.search(q, k)
    nb_cand = got._nb_cand(k)
    batch = max(32, (rerank_cap or tmxu._RERANK_ELEMS) // nb_cand // 32 * 32)
    assert [c[0] for c in calls] == [min(batch, nq - b0) for b0 in range(0, nq, batch)]
    assert len(calls) == (1 if rerank_cap is None else 2)
    ref = jmxu.MxuSearcher(db, compact=tier == "compact", approx=False)
    d_ref, i_ref = ref.search(q, k)
    np.testing.assert_array_equal(ids, i_ref)
    if tier == "full":
        np.testing.assert_array_equal(d.view(np.uint32), d_ref.view(np.uint32))
    else:
        np.testing.assert_allclose(d, d_ref, rtol=0, atol=2.0**-23)


@pytest.mark.parametrize("tier", ["full", "compact"])
def test_mxu_searcher_batch_of_37_equals_a_batch_of_64_sliced(rng, tier):
    """A batch whose size is no power of two goes up as it is (no pad rows):
    its answers equal those of the same queries inside a batch of 64."""
    n, s = (4096, 256) if tier == "full" else (3000, 1024)
    db, q = _planted(rng, n, s, nq=64, per=12)
    searcher = tmxu.MxuSearcher(db, CPU, compact=tier == "compact")
    d64, i64 = searcher.search(q, 10)
    d37, i37 = searcher.search(q[:37], 10)
    assert i37.shape == (37, 10)
    np.testing.assert_array_equal(i37, i64[:37])
    np.testing.assert_array_equal(d37.view(np.uint32), d64[:37].view(np.uint32))
