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

from gsearch_tpu.ops import distance as jdist
from gsearch_tpu_torch.ops import cuda_lib
from gsearch_tpu_torch.ops import distance as tdist


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
