"""gsearch_tpu_torch's graph index and the packed K2 forms against
gsearch_tpu, on the CPU.

Tolerances: packers and equal counts are bit-exact; graph arrays built by
the beam path are equal; a distance is held within 2^-23 (one ulp of 1.0)
of the reference's, because jitted on the CPU XLA divides by a constant
S through its reciprocal where the port divides as IEEE does (see
test_torch_distance.py).  The rerank tiers and the bulk path are in
test_torch_hnsw_tiers.py; the kernels on the card in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsearch_tpu.index.hnsw as jhnsw
import gsearch_tpu_torch.index.hnsw as thnsw
from gsearch_tpu.index.serialize import dump_index as jax_dump, load_index as jax_load
from gsearch_tpu.ops import distance as jdist
from gsearch_tpu.ops import mxu as jmxu
from gsearch_tpu_torch.index.serialize import dump_index as torch_dump, load_index as torch_load
from gsearch_tpu_torch.ops import cuda_lib
from gsearch_tpu_torch.ops import distance as tdist
from gsearch_tpu_torch.ops import mxu as tmxu

CPU = torch.device("cpu")
ULP = 2.0**-23


def sig_cloud(rng, n, s, n_clusters=8):
    """tests/test_index.py's synthetic signatures: cluster members share
    most slots (a random fraction up to one half is redrawn)."""
    centers = rng.integers(0, 1 << 30, size=(n_clusters, s)).astype(np.uint32)
    sigs = np.empty((n, s), dtype=np.uint32)
    for i in range(n):
        c = centers[i % n_clusters].copy()
        mask = rng.random(s) < rng.uniform(0.0, 0.5)
        c[mask] = rng.integers(0, 1 << 30, size=mask.sum(), dtype=np.uint32)
        sigs[i] = c
    return sigs


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


_PACK = {2: (jmxu._pack_hash16, tmxu.pack_hash16), 4: (jmxu._pack_hash8, tmxu.pack_hash8),
         8: (jmxu._pack_hash4, tmxu.pack_hash4)}


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_pack_hash_bit_exact(rng, parts):
    """pack_hash16/8/4 equal the reference's packers reshaped to [R,
    spad/parts], for database and query pads and spad > S."""
    jpack, tpack = _PACK[parts]
    rows = rng.integers(0, 1 << 32, size=(9, 1000), dtype=np.uint64).astype(np.uint32)
    spad = 256 * parts * 8  # > S, whole [8, .] tiles for the reference
    for pad_val in (0, 1):
        want = np.asarray(jpack(jnp.asarray(rows), spad=spad, pad_val=pad_val)).reshape(9, -1)
        got = tpack(_t(rows), spad=spad, pad_val=pad_val).numpy().view(np.uint32)
        assert got.shape == (9, spad // parts)
        np.testing.assert_array_equal(got, want)
    f = rng.random((3, 64), dtype=np.float32)  # f32 signatures by bit pattern
    np.testing.assert_array_equal(
        tpack(torch.from_numpy(f), spad=64 * parts, pad_val=0).numpy().view(np.uint32),
        np.asarray(jpack(jnp.asarray(f.view(np.uint32)), spad=64 * parts, pad_val=0)).reshape(3, -1))


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_gather_hamming_packed_vs_pallas_and_rerank(rng, parts):
    """K2 plain with parts=2/4/8: equal counts equal to the reference's Pallas
    kernel (interpret mode) and its XLA rerank, distances within an ulp;
    out-of-range ids are +inf."""
    jpack, tpack = _PACK[parts]
    lanes, qc, r, n = 1024, 8, 16, 40
    spad = lanes * parts
    s_true = spad - 100  # padded fields never count equal
    base = rng.integers(0, 1 << 30, size=(n, s_true)).astype(np.uint32)
    q = base[rng.integers(0, n, qc)].copy()
    q[:, : s_true // 3] = rng.integers(0, 1 << 30, size=(qc, s_true // 3))
    db_p = tpack(_t(base), spad=spad, pad_val=0)
    q_p = tpack(_t(q), spad=spad, pad_val=1)
    ids = rng.integers(0, n, size=(qc, r)).astype(np.int32)
    ids[:, r // 2:] = ids[:, : r // 2]  # repeated ids
    before = dict(cuda_lib.launches)
    got = tdist.gather_hamming(db_p, q_p, torch.from_numpy(ids), parts=parts, s_true=s_true).numpy()
    assert cuda_lib.launches == before  # a CPU tensor takes the plain version
    eq = np.rint((1.0 - got.astype(np.float64)) * s_true)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  (np.float32(1) - eq.astype(np.float32) / np.float32(s_true)).view(np.uint32))
    # the reference kernel, interpreted, on its [N, 8, Sp/8] layout
    db3 = jpack(jnp.asarray(base), spad=spad, pad_val=0)
    qj = jpack(jnp.asarray(q), spad=spad, pad_val=1).reshape(qc, lanes)
    pal = np.asarray(jdist.gather_hamming_pallas(db3, qj, jnp.asarray(ids), s_true=s_true,
                                                 interpret=True, parts=parts))
    np.testing.assert_array_equal(np.rint((1.0 - pal.astype(np.float64)) * s_true), eq)
    np.testing.assert_allclose(got, pal, rtol=0, atol=ULP)
    # the reference's plain rerank (top-k over all R, then compare sorted)
    d_ref, i_ref = jhnsw._rerank_device(db3, qj, jnp.asarray(ids), jnp.int32(n), knbn=r,
                                        s_true=s_true, use_pallas=False, parts=parts)
    d_sorted, sel = tdist.topk_smallest(torch.from_numpy(got), r)
    np.testing.assert_array_equal(np.take_along_axis(ids, sel.numpy(), 1), np.asarray(i_ref))
    np.testing.assert_allclose(d_sorted.numpy(), np.asarray(d_ref), rtol=0, atol=ULP)
    bad = torch.tensor([[-1, 0, n]], dtype=torch.int32)
    out = tdist.gather_hamming(db_p, q_p[:1], bad, parts=parts, s_true=s_true).numpy()
    assert np.isinf(out[0, [0, 2]]).all() and np.isfinite(out[0, 1])


def _planted(rng, n, s, nq, per):
    db = rng.random((n, s), dtype=np.float32)
    q = rng.random((nq, s), dtype=np.float32)
    for i in range(nq):
        for j in range(per):
            row = q[i].copy()
            pos = rng.choice(s, 40 + 30 * j, replace=False)
            row[pos] = rng.random(len(pos), dtype=np.float32)
            db[rng.integers(n)] = row
    return db, q


@pytest.mark.parametrize("mode", ["compact", "estimator_only"])
def test_mxu_compact_and_estimator_match_reference(rng, mode):
    """The compact tier (m=2, 16-bit hashed rerank through K2 parts=2) and
    the estimator-only pool against the reference's on the CPU: ids equal
    (planted neighbours have distinct distances; the estimator's order is
    the integer score's), distances within an ulp."""
    n, s, k = 3000, 1024, 10
    db, q = _planted(rng, n, s, nq=16, per=12)
    if mode == "compact":
        ref = jmxu.MxuSearcher(db, compact=True, approx=False)
        got = tmxu.MxuSearcher(db, CPU, compact=True)
        assert ref.compact and got.compact and got.m == ref.m == 2
    else:
        ref = jmxu.MxuSearcher(db, m=4, compact=False, estimator_only=True, approx=False)
        got = tmxu.MxuSearcher(db, CPU, m=4, compact=False, estimator_only=True)
        assert got._rr is None
    d_ref, i_ref = ref.search(q, k)
    d, i = got.search(q, k)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=ULP)
    if mode == "compact":  # hashed rerank finds the planted top-k exactly
        _, ex_i = tdist.bucketed_knn(torch.from_numpy(q), torch.from_numpy(db), k)
        np.testing.assert_array_equal(i, ex_i)


def test_tier_choice_matches_reference():
    """planned_footprint and the constructor's tier rule agree with the
    reference's over a grid of (n, S), across the compact boundary."""
    for n in (100, 4096, 65536, 65537, 131072, 250000, 262144, 524288, 1 << 20):
        for s in (128, 1024, 2000, 12000):
            assert tmxu.planned_footprint(n, s) == jmxu.planned_footprint(n, s), (n, s)
            for compact in (None, True, False):
                ref = jmxu.MxuSearcher.__new__(jmxu.MxuSearcher)
                got = tmxu.MxuSearcher.__new__(tmxu.MxuSearcher)
                for obj in (ref, got):
                    obj.n, obj.s = n, s
                # (column pad, expansion width); the reference also returns its n-bucket
                assert got._resolve_mode(4, compact) == ref._resolve_mode(4, compact)[1:], (n, s)
                assert got.compact == ref.compact
    assert tmxu.planned_footprint(65536, 12000)[0] is False   # flat-65k keeps full width
    assert tmxu.planned_footprint(131072, 12000)[0] is True


def test_bulk_knn_pass_distances_match_reference(rng):
    """Pass A of the bulk build (the compact searcher's exact top-C sweep,
    self excluded) gives the reference's sorted kNN distances.  n is a
    power of two: below one, the reference also scores the zero rows that
    pad N to the next, and a pad row can take a candidate slot from a real
    row (its lists then hold +inf or farther rows; the port's are never
    farther)."""
    s = 128
    for n in (2048, 1500):
        sigs = sig_cloud(rng, n, s, n_clusters=32)
        got = thnsw.HnswIndex(sketch_size=s, sig_dtype=np.uint32, max_nb_conn=24,
                              ef_construction=96, search_prefix=s, device=CPU)
        C = min(max(min(2 * got.m0, 512), got.m0), n - 1)
        u_dev = torch.from_numpy(sigs.view(np.int32))
        searcher = tmxu.MxuSearcher(u_dev, CPU, compact=True, nb_cand=min(3 * C, n))
        _, knn_d = got._knn_sweep(searcher, u_dev, 0, n, C, n)
        # the reference's pass A (gsearch_tpu/index/hnsw.py:607-621)
        ref = jmxu.MxuSearcher(sigs, compact=True, nb_cand=min(3 * C, n))
        d, ids = ref.search(sigs, knbn=min(C + 1, n))
        d = np.where(ids == np.arange(n)[:, None], np.inf, d)
        want = np.sort(d, axis=1)[:, :C]
        if n == 2048:
            np.testing.assert_allclose(knn_d, want, rtol=0, atol=ULP)
        else:
            assert (knn_d <= want + ULP).all()


@pytest.fixture(scope="module")
def beam_graphs():
    """The same beam-path build (n=3000, S=128, max_nb_conn 16, ef 64,
    batch 512) by both packages, with 20 held-out queries."""
    rng = np.random.default_rng(42)
    n, s = 3000, 128
    sigs = sig_cloud(rng, n + 20, s, n_clusters=32)
    kw = dict(sketch_size=s, sig_dtype=np.uint32, max_nb_conn=16, ef_construction=64)
    ref = jhnsw.HnswIndex(**kw)
    ref.insert(sigs[:n], batch_size=512, bulk=False)
    got = thnsw.HnswIndex(**kw, device=CPU)
    got.insert(sigs[:n], batch_size=512, bulk=False)
    return ref, got, sigs[n:]


def test_beam_build_graph_arrays_equal(beam_graphs):
    ref, got, _ = beam_graphs
    for name in ("_nbrs", "_nbr_d", "_entry_ids", "_pinned"):
        want, have = getattr(ref, name), getattr(got, name)
        assert have.dtype == want.dtype, name
        np.testing.assert_array_equal(have, want, err_msg=name)


def test_beam_search_matches_reference(beam_graphs):
    ref, got, q = beam_graphs
    d_ref, i_ref = ref.search(q, knbn=10, ef_search=128)
    d, i = got.search(q, knbn=10, ef_search=128)
    assert got.stats["search"]["route"] == "beam" and got.stats["search"]["hops"] > 0
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=ULP)


def test_small_add_beam_insert_matches_reference(beam_graphs, rng):
    """A small append to a built graph (the beam-insert path of `add`,
    incremental link merge and forced back-links) keeps the arrays equal."""
    ref0, got0, _ = beam_graphs
    ref = jhnsw.HnswIndex.__new__(jhnsw.HnswIndex)
    ref.__dict__.update({k: (v.copy() if isinstance(v, np.ndarray) else v)
                         for k, v in ref0.__dict__.items()})
    got = thnsw.HnswIndex.from_jax(ref0, device=CPU)
    extra = sig_cloud(rng, 40, 128, n_clusters=3)
    ref.insert(extra, bulk=False)
    got.insert(extra, bulk=False)
    for name in ("_nbrs", "_nbr_d", "_entry_ids", "_pinned"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
    d, _ = got.search(extra[:8], knbn=1, ef_search=64)
    np.testing.assert_allclose(d[:, 0], 0.0, atol=1e-6)


def test_cross_package_hnsw_databases(beam_graphs, tmp_path):
    """An hnsw database dumped by gsearch_tpu loads in the port and searches
    identically; one dumped by the port loads in gsearch_tpu."""
    ref, got, q = beam_graphs
    for d in ("j", "t", "j2"):
        (tmp_path / d).mkdir()
    jax_dump(ref, str(tmp_path / "j"))
    loaded = torch_load(str(tmp_path / "j"), CPU)
    assert isinstance(loaded, thnsw.HnswIndex)
    d_ref, i_ref = ref.search(q, knbn=5, ef_search=96)
    d, i = loaded.search(q, knbn=5, ef_search=96)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=ULP)

    torch_dump(got, str(tmp_path / "t"))
    back = jax_load(str(tmp_path / "t"))
    assert isinstance(back, jhnsw.HnswIndex)
    for name in ("_nbrs", "_nbr_d", "_entry_ids", "_pinned", "_sigs"):
        np.testing.assert_array_equal(getattr(back, name), getattr(got, name), err_msg=name)
    d2, i2 = back.search(q, knbn=5, ef_search=96)
    np.testing.assert_array_equal(i2, i_ref)
    np.testing.assert_allclose(d2, d_ref, rtol=0, atol=ULP)
    meta = (tmp_path / "t" / "index.meta.json").read_text()
    jax_dump(back, str(tmp_path / "j2"))
    assert (tmp_path / "j2" / "index.meta.json").read_text() == meta


def test_estimator_only_coarse_fallback_pool_matches_reference(rng, monkeypatch):
    """With COARSE_BYTES below the coarse searcher's full representation,
    both packages fall back to an estimator-only pool searcher over the
    prefix, and the port's pool is the reference's."""
    n, s, sp = 3000, 2048, 1024
    db = sig_cloud(rng, n, s, n_clusters=24)
    ref = jhnsw.HnswIndex(sketch_size=s, sig_dtype=np.uint32, max_nb_conn=16,
                          ef_construction=64, search_prefix=sp)
    got = thnsw.HnswIndex(sketch_size=s, sig_dtype=np.uint32, max_nb_conn=16,
                          ef_construction=64, search_prefix=sp, device=CPU)
    ref._sigs = db
    got._sigs = db
    # full rep at nb=4096 is 33.5 MB; estimator-only m=4 is 16.8 MB
    monkeypatch.setattr(jhnsw.HnswIndex, "COARSE_BYTES", 20_000_000)
    monkeypatch.setattr(thnsw.HnswIndex, "COARSE_BYTES", 20_000_000)
    c_ref, c_got = ref._coarse_searcher(), got._coarse_searcher()
    assert c_ref.estimator_only and c_got.estimator_only and c_got._rr is None
    assert c_got.m == c_ref.m == 4
    d_ref, pool_ref = c_ref.search(db[:64, :sp].copy(), knbn=64)
    d, pool = c_got.search(db[:64, :sp].copy(), knbn=64)
    np.testing.assert_array_equal(pool, pool_ref)
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=ULP)
    # a budget below even m=1 leaves no coarse route
    monkeypatch.setattr(thnsw.HnswIndex, "COARSE_BYTES", 1000)
    got._coarse = None
    assert got._coarse_searcher() is None


@pytest.mark.parametrize("version", [(1, 0), (2, 0)])
def test_load_sigs_npy_with_headroom(rng, tmp_path, version):
    """The port's reader (numpy's public header API) fills the same capacity
    buffer as gsearch_tpu's, for both .npy header versions; without
    headroom it reads what np.load reads."""
    from gsearch_tpu.io.npyio import npy_read_with_headroom
    from gsearch_tpu_torch.index.sigfile import load_sigs

    sigs = rng.random((100, 64), dtype=np.float32)
    path = tmp_path / "x.sigs.npy"
    with open(path, "wb") as f:
        np.lib.format.write_array(f, sigs, version=version)
    buf, n = load_sigs(str(tmp_path / "x"), headroom=True)
    ref_buf, ref_n = npy_read_with_headroom(str(path))
    assert n == ref_n == 100 and buf.shape == ref_buf.shape and buf.dtype == ref_buf.dtype
    np.testing.assert_array_equal(buf[:n], sigs)
    exact, n = load_sigs(str(tmp_path / "x"))
    assert n == 100 and exact.shape == sigs.shape and exact.dtype == sigs.dtype
    np.testing.assert_array_equal(exact, np.load(path))
    idx = thnsw.HnswIndex(sketch_size=64, sig_dtype=np.float32, max_nb_conn=4,
                          ef_construction=16, device=CPU)
    idx.adopt_sig_buffer(buf, n)
    idx._append_sigs(rng.random((8, 64), dtype=np.float32))
    assert idx.nb_points == 108 and idx._sigs_buf is buf  # no migration copy
