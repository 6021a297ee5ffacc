"""gsearch_tpu_torch distances (K1 `hamming_frac`, K2 `gather_hamming`) and
exact k-NN against gsearch_tpu.

Tolerances: equal counts are bit-exact, and the port's distances are
bit-exactly the IEEE f32 value of 1 - eq/S.  Jitted on the CPU, XLA rewrites
the reference's division by the constant S as fma(-eq, fl(1/S), 1), which
can differ from that by one ulp of 1.0 (2^-23) when S is not a power of two,
so distances are held to the reference within 2^-23.  Against K2's Pallas
kernel, which computes (S - eq)/S, within one ulp.  Ids are equal in the
same tie order.  The CUDA kernels themselves are tested on the card in
test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsearch_tpu.index.hnsw as jhnsw
from gsearch_tpu.ops import distance as jdist
from gsearch_tpu.ops import mxu as jmxu
from gsearch_tpu_torch.ops import cuda_lib
from gsearch_tpu_torch.ops import distance as tdist
from gsearch_tpu_torch.ops import mxu as tmxu


def _sigs(rng, shape, dtype):
    """Signatures with many equal slots: small integer values."""
    v = rng.integers(0, 4, size=shape)
    return (v / 4).astype(np.float32) if dtype == np.float32 else v.astype(np.uint32)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32)


def _assert_distances(got, ref, s):
    """Equal counts bit-exact, the port's value IEEE 1 - eq/S bit-exact,
    the reference's within one ulp of 1.0 (see the module docstring)."""
    got, ref = np.asarray(got), np.asarray(ref)
    eq = np.rint((1.0 - ref.astype(np.float64)) * s)
    np.testing.assert_array_equal(np.rint((1.0 - got.astype(np.float64)) * s), eq)
    np.testing.assert_array_equal(_bits(got), _bits(np.float32(1) - eq.astype(np.float32) / np.float32(s)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0**-23)


@pytest.mark.parametrize("dtype", [np.float32, np.uint32])
@pytest.mark.parametrize("nq,n,s", [(9, 33, 300), (3, 2500, 64)])
def test_hamming_frac_vs_xla_and_pallas(rng, dtype, nq, n, s):
    q, db = _sigs(rng, (nq, s), dtype), _sigs(rng, (n, s), dtype)
    before = dict(cuda_lib.launches)
    got = tdist.hamming_frac(_t(q), _t(db)).numpy()
    assert cuda_lib.launches == before  # a CPU tensor takes the plain version
    _assert_distances(got, jdist.hamming_frac_xla(jnp.asarray(q), jnp.asarray(db)), s)
    if n < 100:
        pal = jdist.hamming_frac_pallas(jnp.asarray(q), jnp.asarray(db), tq=8, tn=16, sb=128,
                                        inner=64, interpret=True)
        _assert_distances(got, pal, s)


def _jax_gather_layout(db, q, s):
    """The reference kernel's layout: columns padded to a multiple of 1024
    (db pads 0, query pads 1), db pre-shaped [N, 8, Sp/8]."""
    sp = (s + 1023) // 1024 * 1024
    dbp = np.zeros((db.shape[0], sp), np.uint32)
    dbp[:, :s] = db
    qp = np.ones((q.shape[0], sp), np.uint32)
    qp[:, :s] = q
    return jnp.asarray(dbp.reshape(db.shape[0], 8, sp // 8)), jnp.asarray(qp)


@pytest.mark.parametrize("s", [900, 1030])
def test_gather_hamming_vs_pallas_and_xla_rerank(rng, s):
    qc, r, n = 8, 16, 64
    db, q = _sigs(rng, (n, s), np.uint32), _sigs(rng, (qc, s), np.uint32)
    ids = rng.integers(0, n, size=(qc, r)).astype(np.int32)
    ids[:, r // 2:] = ids[:, : r // 2]  # repeated ids
    got = tdist.gather_hamming(_t(db), _t(q), torch.from_numpy(ids)).numpy()
    # the XLA rerank's take + compare (gsearch_tpu/ops/mxu.py:289-298): bit-exact
    rows = jnp.take(jnp.asarray(db), jnp.asarray(ids), axis=0)
    eq = (rows == jnp.asarray(q)[:, None, :]).sum(axis=-1).astype(jnp.float32)
    np.testing.assert_array_equal(_bits(got), _bits(1.0 - eq / jnp.float32(s)))
    # the Pallas kernel's (S - eq)/S: within one ulp
    db3, qp = _jax_gather_layout(db, q, s)
    pal = np.asarray(jdist.gather_hamming_pallas(db3, qp, jnp.asarray(ids), s_true=s, interpret=True))
    ulp = np.abs(got.view(np.int32).astype(np.int64) - pal.view(np.int32).astype(np.int64))
    assert ulp.max() <= 1


def test_gather_hamming_out_of_range_ids_are_inf(rng):
    db, q = _sigs(rng, (10, 50), np.float32), _sigs(rng, (2, 50), np.float32)
    ids = torch.tensor([[0, -1, 9], [10, 3, 2**31 - 1]], dtype=torch.int32)
    got = tdist.gather_hamming(_t(db), _t(q), ids).numpy()
    assert np.isinf(got[0, 1]) and np.isinf(got[1, 0]) and np.isinf(got[1, 2])
    assert np.isfinite(got[0, [0, 2]]).all() and np.isfinite(got[1, 1])


@pytest.mark.parametrize("n,pad", [(40, 0), (200, 56), (1000, 24)])
def test_bucketed_knn_ids_and_tie_order(rng, n, pad):
    """Few distinct values make many exact ties: ids must come back in the
    reference's order (ascending distance, lower id first).  `pad` rows past
    n_valid are never returned, as the reference masks its pad rows."""
    s, k = 24, 12
    db = _sigs(rng, (n, s), np.float32)
    q = _sigs(rng, (7, s), np.float32)
    d_ref, i_ref = jdist.bucketed_knn(q, db, k)
    dbp = np.concatenate([db, np.zeros((pad, s), np.float32)]) if pad else db
    d, i = tdist.bucketed_knn(torch.from_numpy(q), torch.from_numpy(dbp), k, n_valid=n)
    np.testing.assert_array_equal(i, i_ref)
    _assert_distances(d, d_ref, s)
    assert i.dtype == np.int32 and d.dtype == np.float32


def test_brute_force_knn_matches_reference(rng):
    db = _sigs(rng, (300, 64), np.uint32)
    q = db[5:9].copy()
    d_ref, i_ref = jdist.brute_force_knn(jnp.asarray(q), jnp.asarray(db), 10, impl="xla")
    d, i = tdist.brute_force_knn(_t(q), _t(db), 10)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    _assert_distances(d.numpy(), d_ref, 64)
    assert (i.numpy()[:, 0] == np.arange(5, 9)).all()


def test_wrappers_reject_what_kernels_do_not_take():
    f = torch.zeros((2, 8))
    with pytest.raises(TypeError):
        tdist.hamming_frac(f.double(), f.double())
    with pytest.raises(TypeError):
        tdist.hamming_frac(f, f.int())
    with pytest.raises(ValueError):
        tdist.hamming_frac(f, torch.zeros((2, 9)))
    with pytest.raises(ValueError):
        tdist.gather_hamming(f, f, torch.zeros((3, 4), dtype=torch.int32))


@pytest.mark.parametrize("c", [1, 5, 33, 130])
def test_hamming_frac_self_vs_plain_and_reference(rng, c):
    """The self-pair form on [B, C, S] with repeated rows, S not a multiple
    of 64: equal to hamming_frac_plain(x, x) bit for bit, counts bit-exact
    against the reference's XLA path (within 2^-23 in distance), and
    against its Pallas kernel in interpret mode for the small shapes."""
    b, s = 3, 77
    x = _sigs(rng, (b, c, s), np.float32)
    x[:, c // 2:] = x[:, : c - c // 2]  # repeated rows
    before = dict(cuda_lib.launches)
    got = tdist.hamming_frac_self(torch.from_numpy(x)).numpy()
    assert cuda_lib.launches == before  # a CPU tensor takes the plain version
    assert got.shape == (b, c, c)
    want = tdist.hamming_frac_plain(torch.from_numpy(x), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (np.diagonal(got, axis1=1, axis2=2) == 0).all()
    for m in range(b):
        xm = jnp.asarray(x[m])
        _assert_distances(got[m], jdist.hamming_frac_xla(xm, xm), s)
        if c <= 33:
            pal = jdist.hamming_frac_pallas(xm, xm, tq=8, tn=16, sb=128, inner=64, interpret=True)
            _assert_distances(got[m], pal, s)
    # the 2-D form is the batch of one
    np.testing.assert_array_equal(_bits(tdist.hamming_frac_self(torch.from_numpy(x[0])).numpy()),
                                  _bits(got[0]))


# the issue's three shapes (flat index below MXU_MIN_POINTS, the flat-48
# request, the bulk build's pair blocks) and ragged ones; several SM counts
_PLAN_SHAPES = [(1, 37, 4095, 12000, False), (1, 8, 48, 12000, False), (1024, 128, 128, 1024, True),
                (1, 1, 1, 1, False), (3, 70, 4095, 1203, False), (2, 600, 3000, 333, False),
                (5, 130, 130, 1203, True), (1, 1024, 1024, 1024, True), (1, 1, 700, 2048, False),
                (7, 33, 33, 77, True), (1, 512, 4095, 12000, False)]


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("batch,nq,n,s,pairs", _PLAN_SHAPES)
def test_k1_plan_covers_every_pair_once(batch, nq, n, s, pairs, sms):
    """k1_plan's tiles cover every (query, row) pair of a member exactly
    once, or once mirrored for self pairs (never below the diagonal
    outside a diagonal tile); its splits cover S exactly once in whole
    32-slot chunks; no grid dimension passes its limit."""
    plans = [tdist.k1_plan(batch, nq, n, s, sms, pairs=pairs)]
    if not pairs:
        plans += [tdist.k1_plan(batch, nq, n, s, sms, tile=t) for t in tdist.K1_TILES]
    for plan in plans:
        tq, tn, _ = tdist.K1_TILES[plan.tile]
        assert not pairs or (plan.tile == "wide" and tq == tn)
        hits = np.zeros((nq, n), np.int32)
        for q0, n0, mirror in tdist.k1_tiles(plan, pairs=pairs):
            assert not pairs or q0 <= n0
            hits[q0 : q0 + tq, n0 : n0 + tn] += 1
            if mirror:
                hits[n0 : n0 + tn, q0 : q0 + tq] += 1
        np.testing.assert_array_equal(hits, 1, err_msg=str(plan))
        assert plan.span % tdist.K1_CHUNK == 0 and plan.span > 0
        assert (plan.splits - 1) * plan.span < s <= plan.splits * plan.span
        assert plan.tiles <= (1 << 31) - 1 and plan.splits <= 65535 and batch <= 65535
        assert plan.qtiles == -(-nq // tq)


def test_k1_plan_shapes():
    """The tile by shape on an H100 (132 SMs): narrow tiles for request
    shapes, with S split where the tiles cannot fill the card; the wide
    tile for the self pairs of the bulk build, unsplit."""
    assert tdist.k1_plan(1, 8, 48, 12000, 132).tile == "narrow8"
    assert tdist.k1_plan(1, 8, 48, 12000, 132).splits > 1
    assert tdist.k1_plan(1, 37, 4095, 12000, 132).tile.startswith("narrow")
    big = tdist.k1_plan(1024, 128, 128, 1024, 132, pairs=True)
    assert big.tile == "wide" and big.splits == 1 and big.tiles == 3
    with pytest.raises(ValueError):
        tdist.k1_plan(1, 3, 4, 10, 132, pairs=True)
    with pytest.raises(ValueError):
        tdist.k1_plan(1, 3, 3, 10, 132, pairs=True, tile="narrow8")


# ---- K2's forms and its plan ----------------------------------------------------

_PACKERS = {2: (jmxu._pack_hash16, tmxu.pack_hash16), 4: (jmxu._pack_hash8, tmxu.pack_hash8),
            8: (jmxu._pack_hash4, tmxu.pack_hash4)}


def _k2_case(rng, parts, qc, r, n):
    """Port and reference inputs of one K2 case whose lanes pass one
    segment of the row-grouped form: (db, q, s_true) as int32 tensors and
    the reference's (db [N, 8, Sp/8], q [Qc, Sp])."""
    if parts == 1:
        s = 1100
        db, q = _sigs(rng, (n, s), np.uint32), _sigs(rng, (qc, s), np.uint32)
        db3, qj = _jax_gather_layout(db, q, s)
        return _t(db), _t(q), s, db3, qj
    jpack, tpack = _PACKERS[parts]
    lanes = 2048
    spad = lanes * parts
    s_true = spad - 100  # padded fields never count equal
    base = rng.integers(0, 1 << 30, size=(n, s_true)).astype(np.uint32)
    q = base[rng.integers(0, n, qc)].copy()
    q[:, : s_true // 3] = rng.integers(0, 1 << 30, size=(qc, s_true // 3))
    qt, bt = torch.from_numpy(q.view(np.int32)), torch.from_numpy(base.view(np.int32))
    db3 = jpack(jnp.asarray(base), spad=spad, pad_val=0)
    qj = jpack(jnp.asarray(q), spad=spad, pad_val=1).reshape(qc, lanes)
    return tpack(bt, spad=spad, pad_val=0), tpack(qt, spad=spad, pad_val=1), s_true, db3, qj


@pytest.mark.parametrize("form", list(tdist.K2_FORMS))
@pytest.mark.parametrize("parts", [1, 2, 4, 8])
def test_gather_hamming_forms_vs_pallas_and_xla_rerank(rng, parts, form):
    """K2 on the CPU with each form asked for (both take the plain
    version there; the kernels are held to it on the card), every `parts`,
    lanes past one segment of the row-grouped form: equal counts bit-exact
    against the reference's Pallas kernel in interpret mode and its XLA
    rerank, distances within one ulp; ids outside [0, N) +inf."""
    qc, r, n = 8, 16, 40
    db, q, s_true, db3, qj = _k2_case(rng, parts, qc, r, n)
    ids = rng.integers(0, n, size=(qc, r)).astype(np.int32)
    ids[:, r // 2:] = ids[:, : r // 2]  # repeated ids
    ids[:, 0] = 3  # a row every query lists
    before = dict(cuda_lib.launches)
    got = tdist.gather_hamming(db, q, torch.from_numpy(ids), parts=parts, s_true=s_true, form=form)
    assert cuda_lib.launches == before  # a CPU tensor takes the plain version
    want = tdist.gather_hamming_plain(db, q, torch.from_numpy(ids), parts=parts, s_true=s_true)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    eq = np.rint((1.0 - got.numpy().astype(np.float64)) * s_true)
    pal = np.asarray(jdist.gather_hamming_pallas(db3, qj, jnp.asarray(ids), s_true=s_true,
                                                 interpret=True, parts=parts))
    np.testing.assert_array_equal(np.rint((1.0 - pal.astype(np.float64)) * s_true), eq)
    np.testing.assert_allclose(got.numpy(), pal, rtol=0, atol=2.0**-23)
    d_ref, i_ref = jhnsw._rerank_device(db3, qj, jnp.asarray(ids), jnp.int32(n), knbn=r,
                                        s_true=s_true, use_pallas=False, parts=parts)
    d_sorted, sel = tdist.topk_smallest(got, r)
    np.testing.assert_array_equal(np.take_along_axis(ids, sel.numpy(), 1), np.asarray(i_ref))
    np.testing.assert_allclose(d_sorted.numpy(), np.asarray(d_ref), rtol=0, atol=2.0**-23)
    bad = torch.tensor([[-1, 0, n, 2**31 - 1]], dtype=torch.int32)
    out = tdist.gather_hamming(db, q[:1].contiguous(), bad, parts=parts, s_true=s_true, form=form).numpy()
    assert np.isinf(out[0, [0, 2, 3]]).all() and np.isfinite(out[0, 1])


# (Qc, R, N, lanes) of the main path's K2 launches: the coarse route's
# prefix rerank, the full tier, pass A of the bulk build, a beam hop of a
# 1,024-query request and of a CLI request of 8 genomes, the flat index's
# request of 8 genomes and of 1,024
_K2_SHAPES = {"coarse": (1024, 2048, 262144, 1024), "full tier": (1024, 160, 262144, 12000),
              "pass A": (4096, 384, 262144, 1024), "beam hop": (1024, 256, 262145, 1024),
              "beam hop, 8": (8, 256, 262145, 1024), "flat, 8": (8, 80, 65536, 12000),
              "flat, 1024": (1024, 80, 65536, 12000)}


def test_k2_plan_shapes():
    """The form by shape on an H100 (132 SMs): row-grouped where pairs
    repeat rows (the coarse rerank, the full tier), query-major for the
    small launches of a CLI request of a few genomes (a beam hop, the flat
    rerank), whose lanes are cut into spans to fill the card."""
    plan = {k: tdist.k2_plan(*v, 132) for k, v in _K2_SHAPES.items()}
    assert plan["coarse"].form == "row" and plan["full tier"].form == "row"
    assert plan["beam hop, 8"] == tdist.K2Plan("query", plan["beam hop, 8"].unique, 1)
    assert plan["flat, 8"].form == "query" and plan["flat, 8"].splits == 12
    assert all(p.splits == 1 for k, p in plan.items() if k != "flat, 8")
    tdist.k2_plan.cache_clear()  # pure: the same plans computed afresh
    assert {k: tdist.k2_plan(*v, 132) for k, v in _K2_SHAPES.items()} == plan
    assert tdist.k2_plan(1024, 2048, 262144, 1024, 132, form="query").form == "query"
    assert tdist.k2_plan(8, 80, 65536, 12000, 132, form="row") == tdist.K2Plan(
        "row", plan["flat, 8"].unique, 1)
    with pytest.raises(ValueError):
        tdist.k2_plan(8, 80, 65536, 12000, 132, form="rows")
    with pytest.raises(ValueError):
        tdist.gather_hamming(torch.zeros((4, 8)), torch.zeros((2, 8)),
                             torch.zeros((2, 3), dtype=torch.int32), form="tiles")


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("qc,r,n,lanes", [*_K2_SHAPES.values(), (1, 1, 1, 1), (1, 1, 5, 3),
                                          (3, 7, 2, 5000), (33, 80, 2000, 1201)])
def test_k2_plan_spans_cover_the_lanes(qc, r, n, lanes, sms):
    """The query-major form's spans cover a pair's lanes with at least
    K2_SEG lanes each (the kernel rounds a span up to whole 16-byte rounds
    of a warp) and fill one wave where the launch is small; the
    row-grouped form is taken only past one wave of pairs, where rows
    repeat."""
    plan = tdist.k2_plan(qc, r, n, lanes, sms)
    pairs, wave = qc * r, sms * tdist.K2_WAVE_PAIRS
    assert 0 < plan.unique <= min(pairs, n) + 1e-6
    if plan.form == "row":
        assert pairs >= wave and pairs >= tdist.K2_REPEAT * plan.unique and plan.splits == 1
        return
    span = -(-lanes // plan.splits)
    assert plan.splits == 1 or span >= tdist.K2_SEG * (plan.splits - 1) / plan.splits
    assert (plan.splits - 1) * span < lanes <= plan.splits * span
    assert plan.splits == 1 or pairs * (plan.splits - 1) < wave


# ---- u32 and u16 signatures: bits viewed, registers widened by value ---------------

def _hard_rows(rng, n, s, dtype):
    """Rows of few distinct values (many equal slots) among the patterns a
    float compare or a pairwise reinterpretation would get wrong: NaN
    payloads (equal bits, unequal as floats), +0 / -0 (unequal bits, equal
    as floats), values past 2^31, and u16 registers with equal low bytes."""
    if dtype == np.uint16:
        vals = np.array([0, 1, 0x0100, 0x0101, 0x8000, 0xFFFF, 0x00FF, 0xFF00], np.uint16)
    else:
        vals = np.array([0x7FC00000, 0x7FC00001, 0xFFC00000, 0x00000000, 0x80000000,
                         0x0001FFFF, 0x0002FFFF, 0xFFFFFFFF], np.uint32)
    return vals[rng.integers(0, len(vals), size=(n, s))]


@pytest.mark.parametrize("dtype", [np.uint32, np.uint16])
def test_k1_k2_knn_on_u32_and_u16_rows(rng, dtype):
    n, nq, s = 120, 7, 96
    db = _hard_rows(rng, n, s, dtype)
    q = db[rng.integers(0, n, nq)].copy()
    q[:, : s // 3] = _hard_rows(rng, nq, s // 3, dtype)
    tq, tdb = tdist.as_int32_rows(q), tdist.as_int32_rows(db)
    assert tdb.dtype == torch.int32 and tdb.shape == (n, s)  # u16 widened, not paired
    np.testing.assert_array_equal(tdb.numpy().view(np.uint32), db.astype(np.uint32))
    eq = (q[:, None, :] == db[None, :, :]).sum(-1)  # integer equality: the truth
    got = tdist.hamming_frac(tq, tdb).numpy()
    np.testing.assert_array_equal(np.rint((1.0 - got.astype(np.float64)) * s), eq)
    _assert_distances(got, jdist.hamming_frac_xla(jnp.asarray(q), jnp.asarray(db)), s)
    pal = jdist.hamming_frac_pallas(jnp.asarray(q), jnp.asarray(db), tq=8, tn=16, sb=128,
                                    inner=64, interpret=True)
    _assert_distances(got, pal, s)
    # a torch tensor of the unsigned type is taken as the numpy rows are
    np.testing.assert_array_equal(
        _bits(tdist.hamming_frac(torch.from_numpy(q), torch.from_numpy(db)).numpy()), _bits(got))
    ids = rng.integers(0, n, size=(nq, 10)).astype(np.int32)
    g = tdist.gather_hamming(tdb, tq, torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(np.rint((1.0 - g.astype(np.float64)) * s),
                                  np.take_along_axis(eq, ids.astype(np.int64), 1))
    d_ref, i_ref = jdist.brute_force_knn(jnp.asarray(q), jnp.asarray(db), 9, impl="xla")
    d, i = tdist.brute_force_knn(tq, tdb, 9)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    _assert_distances(d.numpy(), d_ref, s)
    d2, i2 = tdist.bucketed_knn(tq, tdb, 9)
    d2_ref, i2_ref = jdist.bucketed_knn(q, db, 9)
    np.testing.assert_array_equal(i2, i2_ref)
    _assert_distances(d2, d2_ref, s)


def test_sig_bits_names_the_accepted_types():
    for bad in (np.zeros((2, 4), np.float64), np.zeros((2, 4), np.uint8), np.zeros((2, 4), np.int64)):
        with pytest.raises(TypeError, match="float32, int32, uint32 or uint16"):
            tdist.sig_bits(bad)
    with pytest.raises(TypeError, match="float32, int32, uint32 or uint16"):
        tdist.hamming_frac(torch.zeros((2, 8), dtype=torch.int16), torch.zeros((2, 8), dtype=torch.int16))
    f = np.array([[0.0, -0.0, np.nan]], np.float32)
    assert tdist.sig_bits(f).base is f  # 32-bit types are viewed, not converted
    np.testing.assert_array_equal(tdist.sig_bits(f).view(np.uint32), f.view(np.uint32))


@pytest.mark.parametrize("dtype", [np.uint32, np.uint16])
def test_searcher_and_graph_on_u32_and_u16_rows(rng, dtype):
    """MxuSearcher and HnswIndex (beam build and search) on rows of the
    hard patterns, clustered so neighbours exist: gsearch_tpu's ids and
    distances."""
    import gsearch_tpu_torch.index.hnsw as thnsw

    n, s, k = 4200, 64, 8
    centers = _hard_rows(rng, 40, s, dtype)
    db = centers[np.arange(n) % 40].copy()
    redraw = rng.random((n, s)) < rng.uniform(0.05, 0.6, size=(n, 1))
    db[redraw] = _hard_rows(rng, n, s, dtype)[redraw]
    q = db[rng.integers(0, n, 12)].copy()
    q[:, :5] = _hard_rows(rng, 12, 5, dtype)
    cpu = torch.device("cpu")
    got_d, got_i = tmxu.MxuSearcher(db, cpu).search(q, k)
    ex_d, ex_i = tdist.bucketed_knn(tdist.as_int32_rows(q), tdist.as_int32_rows(db), k)
    np.testing.assert_array_equal(got_d.view(np.uint32), ex_d.view(np.uint32))
    want_d, _ = jmxu.MxuSearcher(db, m=4, rerank_factor=8, approx=False).search(q, k)
    np.testing.assert_array_equal(got_d.view(np.uint32), want_d.view(np.uint32))
    np.testing.assert_array_equal(np.asarray(jmxu.expand_signs(jnp.asarray(db[:50].astype(np.uint32)), m=4)),
                                  tmxu.expand_signs(tdist.as_int32_rows(db[:50]), 4).numpy())

    kw = dict(sketch_size=s, sig_dtype=dtype, max_nb_conn=8, ef_construction=32)
    ref = jhnsw.HnswIndex(**kw)
    ref.insert(db[:1500], batch_size=512, bulk=False)
    got = thnsw.HnswIndex(**kw, device=cpu)
    got.insert(db[:1500], batch_size=512, bulk=False)
    for name in ("_nbrs", "_nbr_d", "_entry_ids", "_pinned", "_sigs"):
        want, have = getattr(ref, name), getattr(got, name)
        assert have.dtype == want.dtype, name
        np.testing.assert_array_equal(have[: len(want)] if name == "_sigs" else have, want, err_msg=name)
    d_ref, i_ref = ref.search(q, knbn=5, ef_search=64)
    d, i = got.search(q, knbn=5, ef_search=64)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=2.0**-23)
