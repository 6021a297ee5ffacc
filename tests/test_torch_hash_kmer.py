"""gsearch_tpu_torch hashes and k-mer windows against gsearch_tpu: bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsearch_tpu.ops import hash as jhash
from gsearch_tpu.ops import kmer as jkmer
from gsearch_tpu_torch.ops import hash as thash
from gsearch_tpu_torch.ops import kmer as tkmer


def _u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.int64))


def _same(j, t) -> None:
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


@pytest.mark.parametrize("seed", [0, 0x5EED ^ 0x0BADF00D, 0xFFFFFFFF])
def test_mixers_bit_exact(rng, seed):
    x, y = _u32(rng, (4, 257)), _u32(rng, (4, 257))
    x[0, :4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    _same(jhash.mix32(jnp.asarray(x), seed), thash.mix32(_t(x), seed))
    _same(jhash.mix2(jnp.asarray(x), jnp.asarray(y), seed), thash.mix2(_t(x), _t(y), seed))


def test_uniform01_and_u32_views_bit_exact(rng):
    h = _u32(rng, 1000)
    h[:3] = [0, 0xFFFFFFFF, 0xFF]
    got = thash.uniform01(_t(h)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(jhash.uniform01(jnp.asarray(h))).view(np.uint32),
                                  got.view(np.uint32))
    sigs = rng.random((3, 50), dtype=np.float32)
    np.testing.assert_array_equal(thash.as_u32(torch.from_numpy(sigs)).numpy(),
                                  sigs.view(np.uint32).astype(np.int64))


def _codes(rng, shape):
    """DNA codes with invalid symbols: separators (255) and other codes >= 4."""
    c = rng.integers(0, 4, size=shape).astype(np.uint8)
    c[rng.random(shape) < 0.03] = 255
    c[rng.random(shape) < 0.01] = 4
    return c


@pytest.mark.parametrize("k", [5, 16, 21, 31])
def test_canonical_windows_bit_exact(rng, k):
    codes = _codes(rng, (3, 301))
    jc, tc = jnp.asarray(codes), torch.from_numpy(codes)
    for j, t in zip(jkmer.kmer_windows(jc, k, jkmer.DNA_BITS), tkmer.kmer_windows(tc, k, tkmer.DNA_BITS)):
        _same(j, t)
    hi, lo, _ = jkmer.kmer_windows(jc, k, jkmer.DNA_BITS)
    thi, tlo, _ = tkmer.kmer_windows(tc, k, tkmer.DNA_BITS)
    for j, t in zip(jkmer.reverse_complement(hi, lo, k), tkmer.reverse_complement(thi, tlo, k)):
        _same(j, t)
    for j, t in zip(jkmer.canonical_dna_windows(jc, k), tkmer.canonical_dna_windows(tc, k)):
        _same(j, t)


def test_canonical_windows_match_brute_force(rng):
    """Reverse-complement invariance: a sequence and its reverse complement
    yield the same canonical k-mer multiset."""
    k = 21
    codes = rng.integers(0, 4, size=500).astype(np.uint8)
    rc = (3 - codes[::-1]).copy()
    out = []
    for c in (codes, rc):
        hi, lo, valid = tkmer.canonical_dna_windows(torch.from_numpy(c), k)
        v = valid.numpy()
        out.append(sorted(zip(hi.numpy()[v].tolist(), lo.numpy()[v].tolist())))
    assert out[0] == out[1] and len(out[0]) == 500 - k + 1


def test_aa_width_windows_bit_exact(rng):
    codes = rng.integers(0, 22, size=(2, 120)).astype(np.uint8)
    for j, t in zip(jkmer.kmer_windows(jnp.asarray(codes), 12, jkmer.AA_BITS),
                    tkmer.kmer_windows(torch.from_numpy(codes), 12, tkmer.AA_BITS)):
        _same(j, t)


def test_exp_from_bits_mismatch_fraction_bounded():
    """`exp_from_bits` takes its log in float64 rounded to f32, the
    reference an f32 log jitted by XLA: the uniform is bit-exact, the draw
    differs by at most an ulp, and on a bounded fraction of the inputs
    (measured over the 2^20 inputs h = i << 12: 0.1422 of them on an
    x86-64 CPU; bound 0.2).  Run with -s to print the fraction."""
    h = (np.arange(1 << 20, dtype=np.uint32) << np.uint32(12))
    want = np.asarray(jhash.exp_from_bits(jnp.asarray(h)))
    got = thash.exp_from_bits(_t(h)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all() and (got >= 0).all()
    ulps = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32).astype(np.int64))
    frac = float((ulps != 0).mean())
    print(f"exp_from_bits: {frac:.6f} of {h.size} draws differ from gsearch_tpu's, max {ulps.max()} ulp")
    assert ulps.max() <= 1
    assert frac <= 0.2
    # the port's value is the correctly rounded one wherever numpy's float64 log is
    exact = (-np.log((h >> 8).astype(np.float64) + 1.0) + 24 * np.log(2.0)).astype(np.float32)
    assert float((got != exact).mean()) < 1e-3


@pytest.mark.parametrize("k", [5, 7, 12])
def test_aa_windows_bit_exact(rng, k):
    """Amino-acid windows (5 bits a residue, no canonical form): codes 0..19
    valid, 20.. and separators invalid; k = 7 and 12 need the (hi, lo) pair."""
    codes = rng.integers(0, 20, size=(3, 257)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.03] = 255
    codes[rng.random(codes.shape) < 0.02] = 20
    codes[0, :3] = 19
    for j, t in zip(jkmer.kmer_windows(jnp.asarray(codes), k, jkmer.AA_BITS),
                    tkmer.kmer_windows(torch.from_numpy(codes), k, tkmer.AA_BITS)):
        _same(j, t)
    with pytest.raises(ValueError):
        tkmer.kmer_windows(torch.from_numpy(codes), 13, tkmer.AA_BITS)
