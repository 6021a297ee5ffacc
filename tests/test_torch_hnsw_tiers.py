"""gsearch_tpu_torch's graph index against gsearch_tpu on the CPU: the four
device rerank tiers and the host rerank route over a graph the reference
built and carried across with `HnswIndex.from_jax`, with the host re-score
native and on its numpy fallback, and the bulk build and bulk append.

Tiers are forced by lowering `_RERANK_DEVICE_BYTES` in both packages, as
tests/test_index.py does.  Ids must be equal and distances within 2^-23
(one ulp of 1.0, XLA's reciprocal division on the CPU).  The bulk path
can differ from the reference's only at distance ties (MxuSearcher orders
ties by id, the reference by candidate score), so it is held to the
recall of the reference (its pass-A kNN distances are checked in
test_torch_hnsw.py)."""

import numpy as np
import pytest
import torch

import gsearch_tpu.index.hnsw as jhnsw
import gsearch_tpu_torch.index.hnsw as thnsw
from gsearch_tpu_torch.ops import distance as tdist
from gsearch_tpu_torch.ops import host_rescore
from test_torch_hnsw import CPU, ULP, sig_cloud

S_TIERS = 6144  # one sketch size at which all four tiers can be chosen
NBP1 = 4096 + 1  # next_pow2(n) + 1 for the fixture's n
# per-row byte budgets (x NBP1) that leave exactly one tier:
#   full needs 4 * 6144; packed 2 * 6144 of 0.7 * budget; packed8 8192; packed4 4096;
#   below that the host rerank route
_BUDGETS = {"full": None, "packed": 20000, "packed8": 15000, "packed4": 8000, "host": 4000}


@pytest.fixture(scope="module")
def carried():
    rng = np.random.default_rng(42)
    n = 2400
    sigs = sig_cloud(rng, n + 16, S_TIERS, n_clusters=24)
    ref = jhnsw.HnswIndex(sketch_size=S_TIERS, sig_dtype=np.uint32, max_nb_conn=16,
                          ef_construction=64, search_prefix=1024)
    ref.insert(sigs[:n], bulk=False)
    return ref, thnsw.HnswIndex.from_jax(ref, device=CPU), sigs[n:]


@pytest.mark.parametrize("tier,fallback", [
    *(pytest.param(t, False, id=t) for t in _BUDGETS),
    *(pytest.param(t, True, id=f"{t}-fallback") for t in ("packed8", "packed4", "host"))])
def test_tier_search_matches_reference(carried, monkeypatch, tier, fallback):
    """The fallback cases count the host re-score in numpy (the native
    library made unloadable) and must give the native run's distances bit
    for bit."""
    ref, got, q = carried
    if _BUDGETS[tier] is not None:
        monkeypatch.setattr(jhnsw, "_RERANK_DEVICE_BYTES", _BUDGETS[tier] * NBP1)
        monkeypatch.setattr(thnsw, "_RERANK_DEVICE_BYTES", _BUDGETS[tier] * NBP1)
    assert ref._rerank_tier() == got._rerank_tier()
    assert got._rerank_tier()[0] == tier
    d_ref, i_ref = ref.search(q, knbn=10, ef_search=96)
    d, i = got.search(q, knbn=10, ef_search=96)
    want = {"route": "beam", "hops": got.stats["search"]["hops"]}
    assert got.stats["search"] == (want if tier == "host" else {**want, "tier": tier})
    if tier not in ("full", "host"):
        w, bits, buf = got._device_packed
        assert 32 // bits == {"packed": 2, "packed8": 4, "packed4": 8}[tier]
        assert buf.shape == (got.nb_points, w * bits // 32)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=ULP)
    if fallback:
        assert host_rescore.get_lib() is not None
        monkeypatch.setattr(host_rescore, "get_lib", lambda: None)
        d_np, i_np = got.search(q, knbn=10, ef_search=96)
        np.testing.assert_array_equal(i_np, i_ref)
        np.testing.assert_array_equal(d_np.view(np.uint32), d.view(np.uint32))


def _tie_aware(got_d, true_d, k):
    """Recall that counts a miss only where a returned distance is strictly
    worse than the oracle's (tests/test_index.py's measure)."""
    return np.mean([
        1.0 - sum(1 for a, b in zip(sorted(got_d[i]), sorted(true_d[i])) if a > b + 1e-6) / k
        for i in range(len(true_d))])


def test_bulk_build_and_add_recall(rng):
    """Bulk build (n=3000) then bulk append (+1500): tie-aware recall@10
    against the exact oracle at least the reference test's 0.99 after the
    build, and never more than 0.01 below the reference's own at either
    stage."""
    n0, n1, s, k = 3000, 1500, 128, 10
    base = sig_cloud(rng, n0 + 20, s, n_clusters=32)
    base, q0 = base[:n0], base[n0:]
    extra = sig_cloud(rng, n1, s, n_clusters=16)
    q1 = np.concatenate([q0, base[:40], extra[:40]])
    kw = dict(sketch_size=s, sig_dtype=np.uint32, max_nb_conn=24, ef_construction=96,
              search_prefix=s)
    ref = jhnsw.HnswIndex(**kw)
    got = thnsw.HnswIndex(**kw, device=CPU)
    for stage, new, q in (("build", base, q0), ("add", extra, q1)):
        ref.insert(new, bulk=True)
        got.insert(new, bulk=True)
        assert ("build_s" if stage == "build" else "add_s") in got.stats
        db = torch.from_numpy(got.get_sigs().view(np.int32))
        true_d, _ = tdist.bucketed_knn(torch.from_numpy(q.view(np.int32)), db, k)
        r_ref = _tie_aware(ref.search(q, knbn=k, ef_search=128)[0], true_d, k)
        r_got = _tie_aware(got.search(q, knbn=k, ef_search=128)[0], true_d, k)
        assert r_got >= r_ref - 0.01, (stage, r_got, r_ref)
        if stage == "build":
            assert r_got >= 0.99, r_got
    assert got.nb_points == n0 + n1
    assert got._prefix_dev is not None and got._prefix_dev[0] == n0 + n1


@pytest.mark.parametrize("tier", ["full", "packed8", "host"])
def test_tier_search_batch_of_37_equals_a_batch_of_64_sliced(carried, monkeypatch, tier):
    """37 queries go up with 27 pad rows (to 64); their answers equal those
    of the same queries inside a batch of 64, which has none."""
    _, got, _ = carried
    if _BUDGETS[tier] is not None:
        monkeypatch.setattr(thnsw, "_RERANK_DEVICE_BYTES", _BUDGETS[tier] * NBP1)
    assert got._rerank_tier()[0] == tier
    rng = np.random.default_rng(37)
    q = got._sigs[rng.choice(got.nb_points, 64, replace=False)].copy()
    redraw = rng.random(q.shape) < 0.2
    q[redraw] = rng.integers(0, 1 << 30, size=int(redraw.sum()), dtype=np.uint32)
    d64, i64 = got.search(q, knbn=10, ef_search=96)
    d37, i37 = got.search(q[:37], knbn=10, ef_search=96)
    assert i37.shape == (37, 10)
    np.testing.assert_array_equal(i37, i64[:37])
    np.testing.assert_array_equal(d37.view(np.uint32), d64[:37].view(np.uint32))
