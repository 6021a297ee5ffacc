"""gsearch_tpu_torch's SuperMinHash, SuperMinHash2, ProbMinHash, SetSketch,
HyperMinHash and FracMinHash sketchers against gsearch_tpu's, on the CPU.

Tolerances.  SUPER, SUPER2, HyperMinHash and FracMinHash use integers and
exact int -> f32 conversions only: bit-exact.  ProbMinHash ("prob") and
SetSketch ("hll") take an f32 logarithm, which differs by an ulp between
XLA and the port (tests/test_torch_hash_kmer.py measures 14% of the draws):
a ProbMinHash slot changes winner only where two darts lie an ulp apart, a
SetSketch register moves by one only at a level's edge.  Measured here on
24 genomes of 60-200 kb at s = 4,096 (`test_log_sketchers_mismatch_fraction`,
run with -s): prob 1.0e-5 of all slots, at most 1 slot of a genome; hll
1.1e-4 of all slots, at most 2 slots of a genome.  The bounds below are
0.1% of a genome's slots (PER_GENOME x S: 4 of 4,096, 12 of 12,000), and
5e-5 / 5.6e-4 of all slots.  Exception: a sparse genome (fewer darts than
slots) whose least ProbMinHash key lands an ulp apart differs in every
empty slot (test_prob_sparse_genomes_empty_slots)."""

import numpy as np
import pytest
import torch

from gsearch_tpu.core.params import SeqSketcherParams as JaxParams
from gsearch_tpu.models import fracminhash as jfrac
from gsearch_tpu.models import hyperminhash as jhyper
from gsearch_tpu.models import make_sketcher as jax_sketcher
from gsearch_tpu_torch.core.params import SeqSketcherParams
from gsearch_tpu_torch.models import fracminhash as tfrac
from gsearch_tpu_torch.models import hyperminhash as thyper
from gsearch_tpu_torch.models import make_sketcher
from test_torch_sketch import _packed, _ref

# The suite runs on several xdist workers, each importing this file: torch's
# intra-op pool (one thread a core by default) in every worker oversubscribes
# the cores, and the port's many small int64 ops then wait on each other.
torch.set_num_threads(2)

CPU = torch.device("cpu")
EXACT = ("SUPER", "SUPER2")
LOGGED = ("PROB3A", "HLL")
SIG_DTYPES = {"SUPER": np.float32, "SUPER2": np.uint32, "PROB3A": np.uint32, "HLL": np.uint16}
# slots of one genome that may differ for the sketchers that take a log
PER_GENOME = 1e-3


def _pair(algo, s, max_block_log2=None, data_t="DNA", k=16):
    kw = dict(kmer_size=k, sketch_size=s, algo=algo, data_t=data_t)
    j, t = jax_sketcher(JaxParams(**kw)), make_sketcher(SeqSketcherParams(**kw), device=CPU)
    j._upload_raw = False
    if max_block_log2 is not None:
        j.MAX_BLOCK_LOG2 = t.MAX_BLOCK_LOG2 = max_block_log2
    return j, t


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _hold(algo, want: np.ndarray, got: np.ndarray, names):
    """Bit-exact, or within the stated tolerance for the log sketchers."""
    assert want.dtype == got.dtype == SIG_DTYPES[algo] and want.shape == got.shape
    for i, name in enumerate(names):
        if algo in EXACT:
            np.testing.assert_array_equal(_bits(got[i]), _bits(want[i]), err_msg=f"{algo} {name}")
            continue
        diff = got[i] != want[i]
        assert diff.sum() <= max(1, PER_GENOME * diff.size), (algo, name, int(diff.sum()))
        if algo == "HLL" and diff.any():
            assert np.abs(got[i].astype(np.int64) - want[i].astype(np.int64))[diff].max() == 1


def _genomes(rng):
    g = {
        "empty": np.empty(0, np.uint8),
        "shorter-than-k": rng.integers(0, 4, size=10).astype(np.uint8),
        "one-block": rng.integers(0, 4, size=12_000).astype(np.uint8),
        "two-pieces": rng.integers(0, 4, size=33_000).astype(np.uint8),
        "five-pieces": rng.integers(0, 4, size=70_001).astype(np.uint8),
        "n-runs": rng.integers(0, 4, size=40_000).astype(np.uint8),
    }
    # at most 1,024 invalid positions: past that the reference sends a short
    # genome's batch down its bit-plane path, whose padding is uninitialised
    for st in rng.integers(0, 15_000, 12):
        g["n-runs"][st : st + 60] = 255
    # repeated content: multiplicities above one, and across the pieces
    g["duplicated"] = np.concatenate([g["one-block"]] * 3 + [g["two-pieces"][:9_000]])
    return g


@pytest.mark.parametrize("algo", [*EXACT, *LOGGED])
@pytest.mark.parametrize("max_block_log2", [None, 14])
def test_sketch_many_against_reference(rng, algo, max_block_log2):
    """One row a genome (default blocks) and the piece path (16,384-symbol
    blocks), as code arrays and as PackedCodes."""
    genomes = _genomes(rng)
    names, codes = list(genomes), list(genomes.values())
    j, t = _pair(algo, 512, max_block_log2)
    assert t.SIG_DTYPE == j.SIG_DTYPE == SIG_DTYPES[algo]
    assert t.MAX_BLOCK_LOG2 == j.MAX_BLOCK_LOG2
    _hold(algo, j.sketch_many(_ref(codes)), t.sketch_many(codes), names)
    packed = [_packed(c) for c in codes]
    _hold(algo, j.sketch_many(_ref(packed)), t.sketch_many(packed), names)
    one = t.sketch_codes(genomes["five-pieces"])
    np.testing.assert_array_equal(_bits(one), _bits(t.sketch_many(codes)[names.index("five-pieces")]))


def test_probminhash_pieces_are_not_4_aligned(rng):
    """ProbMinHash counts multiplicities a piece, so a long PackedCodes
    genome is unpacked and cut at exactly k - 1 overlap (its block is 2^23,
    lowered here); OptDens cuts the packed form at 4-aligned starts."""
    g = rng.integers(0, 4, size=50_001).astype(np.uint8)
    j, t = _pair("PROB3A", 256)
    assert t.MAX_BLOCK_LOG2 == 23 and t.MULTIPLICITY_SENSITIVE
    j.MAX_BLOCK_LOG2 = t.MAX_BLOCK_LOG2 = 14
    step = (1 << 14) - 15
    assert step % 4 != 0
    for form in (g, _packed(g)):
        pieces = t._pieces(form)
        assert [len(p) for p, _ in pieces] == [len(g[st : st + (1 << 14)]) for st in range(0, len(g), step)]
        np.testing.assert_array_equal(pieces[1][0], g[step : step + (1 << 14)])
    _, o = _pair("OPTDENS", 256, 14)
    assert len(o._pieces(_packed(g))[0][0]) == 1 << 14
    np.testing.assert_array_equal(o._pieces(_packed(g))[1][0], g[step - step % 4 :][: 1 << 14])
    _hold("PROB3A", j.sketch_many(_ref([_packed(g)])), t.sketch_many([_packed(g)]), ["packed"])


def test_probminhash_scale_invariance(rng):
    """J_P is scale-invariant: a genome and itself three times over (with
    separators) give the same signature, in the port as in the reference."""
    g = rng.integers(0, 4, size=20_000).astype(np.uint8)
    sep = np.full(1, 255, np.uint8)
    tripled = np.concatenate([g, sep, g, sep, g])
    _, t = _pair("PROB3A", 512)
    a, b = t.sketch_many([g, tripled])
    assert (a != b).mean() <= PER_GENOME
    other = t.sketch_codes(rng.integers(0, 4, size=20_000).astype(np.uint8))
    assert (a != other).mean() > 0.95


@pytest.mark.parametrize("algo", LOGGED)
def test_log_sketchers_mismatch_fraction(algo):
    """The measured fraction of slots that differ from gsearch_tpu's (see
    the module docstring), printed with -s and held to a few times it."""
    rng = np.random.default_rng(7)
    genomes = [rng.integers(0, 4, size=int(n)).astype(np.uint8) for n in np.linspace(60_000, 200_000, 24)]
    s = 4096
    j, t = _pair(algo, s)
    want, got = j.sketch_many(genomes), t.sketch_many(genomes)
    diff = want != got
    print(f"{algo}: {diff.mean():.3e} of {diff.size} slots differ from gsearch_tpu's; "
          f"at most {int(diff.sum(1).max())} of {diff.shape[1]} in a genome")
    assert diff.sum(1).max() <= int(PER_GENOME * s)
    assert diff.mean() <= (5e-5 if algo == "PROB3A" else 5.6e-4)
    if algo == "HLL" and diff.any():
        assert np.abs(want.astype(np.int64) - got.astype(np.int64))[diff].max() == 1
    # pairwise distances move by at most 0.004
    dj = (want[:, None, :] != want[None, :, :]).mean(-1)
    dt = (got[:, None, :] != got[None, :, :]).mean(-1)
    assert np.abs(dj - dt).max() <= 0.004


def test_hll_per_genome_bound_at_published_width():
    """At s = 12,000 the per-genome bound scales with S (PER_GENOME * S =
    12 slots); measured here at most 2 of 12,000 in a genome (8 genomes of
    60-200 kb), and 3 in one sparse genome of 64 at the re-anchor's run."""
    rng = np.random.default_rng(7)
    genomes = [rng.integers(0, 4, size=int(n)).astype(np.uint8) for n in np.linspace(60_000, 200_000, 8)]
    s = 12_000
    j, t = _pair("HLL", s)
    want, got = j.sketch_many(genomes), t.sketch_many(genomes)
    diff = want != got
    print(f"HLL at s={s}: at most {int(diff.sum(1).max())} slots of a genome differ")
    assert diff.sum(1).max() <= int(PER_GENOME * s)
    if diff.any():
        assert np.abs(want.astype(np.int64) - got.astype(np.int64))[diff].max() == 1


# share of sparse genomes whose empty ProbMinHash slots may differ from
# gsearch_tpu's (see test_prob_sparse_genomes_empty_slots)
PROB_SPARSE_GENOMES = 0.35


def test_prob_sparse_genomes_empty_slots():
    """A genome with fewer darts than slots leaves slots empty; ProbMinHash
    fills them with mix32(slot ^ fingerprint), the fingerprint being the
    genome's least race key: the f32 bits of an arrival time, which carry
    the log's last ulp.  Where that one value differs from the reference's,
    every empty slot differs, while the found slots agree exactly.  DNA
    k = 16, s = 4,096, 64 genomes of 600 bases (35% of slots found):
    measured 13-15 of 64 genomes (0.20-0.23, seeds 7-9; 6-22% over other
    shapes, s = 12,000 and AA k = 7 among them), ~2,670 empty slots each;
    held under PROB_SPARSE_GENOMES.  A prob database and its queries should
    be sketched by one package."""
    rng = np.random.default_rng(7)
    genomes = [rng.integers(0, 4, size=600).astype(np.uint8) for _ in range(64)]
    j, t = _pair("PROB3A", 4096)
    found = []
    finalize = t._finalize_race
    t._finalize_race = lambda race: (found.append(race.found.clone()), finalize(race))[1]
    want, got = j.sketch_many(genomes), t.sketch_many(genomes)
    f = found[0].numpy()
    assert f.shape == want.shape and 0.2 < f.mean() < 0.5
    np.testing.assert_array_equal(got[f], want[f])
    differ = (want != got).any(1)
    print(f"prob sparse: {int(differ.sum())} of {len(genomes)} genomes differ in their empty slots")
    assert differ.mean() < PROB_SPARSE_GENOMES


def test_superminhash_filler_bits(rng):
    """A sparse genome leaves most slots empty: SUPER's filler is
    1e6 + f32(fingerprint) with fingerprints up to 2^32, rounded to nearest
    even as the reference's u32 -> f32 conversion; compared by bits."""
    g = rng.integers(0, 4, size=60).astype(np.uint8)
    for algo in EXACT:
        j, t = _pair(algo, 4096)
        want, got = j.sketch_codes(g), t.sketch_codes(g)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        if algo == "SUPER":
            assert (got >= 1e6).mean() > 0.9 and np.isfinite(got).all()


@pytest.mark.parametrize("is_aa,k", [(False, 16), (True, 7)])
def test_hyperminhash_bit_exact(rng, is_aa, k):
    alpha = 20 if is_aa else 4
    genomes = [rng.integers(0, alpha, size=n).astype(np.uint8) for n in (5, 3_000, 50_000)]
    genomes[2][100:180] = 255
    j = jhyper.make_hyperminhash(nb_buckets=1024, kmer_size=k, is_aa=is_aa)
    t = thyper.make_hyperminhash(nb_buckets=1024, kmer_size=k, is_aa=is_aa, device=CPU)
    j._upload_raw = False
    want, got = j.sketch_many(genomes), t.sketch_many(genomes)
    assert want.dtype == got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t.sketch_codes(genomes[1]), j.sketch_codes(genomes[1]))
    x = rng.integers(0, 2**32, size=1000, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0x80000000, 0xFFFFFFFF]
    import jax.numpy as jnp
    np.testing.assert_array_equal(thyper._clz32(torch.from_numpy(x.astype(np.int64))).numpy(),
                                  np.asarray(jhyper._clz32(jnp.asarray(x))).astype(np.int64))
    a, b = got[1], got[2]
    assert thyper.similarity(a, b) == jhyper.similarity(a, b)
    assert thyper.cardinality(a) == jhyper.cardinality(a)
    np.testing.assert_array_equal(thyper.union(a, b), jhyper.union(a, b))


@pytest.mark.parametrize("is_aa,k", [(False, 16), (True, 7)])
def test_fracminhash_bit_exact(rng, is_aa, k, monkeypatch):
    alpha = 20 if is_aa else 4
    kw = dict(kmer_size=k, sketch_size=1024, algo="OPTDENS", data_t="AA" if is_aa else "DNA")
    genomes = [rng.integers(0, alpha, size=n).astype(np.uint8) for n in (0, 5, 30_000, 70_000)]
    genomes[3][500:600] = 255
    for scaled, num in ((50, None), (200, 40)):
        j = jfrac.FracMinHashSketcher(JaxParams(**kw), scaled=scaled, num=num)
        t = tfrac.FracMinHashSketcher(SeqSketcherParams(**kw), scaled=scaled, num=num, device=CPU)
        for g in genomes:
            want, got = j.sketch_codes(g), t.sketch_codes(g)
            assert got.dtype == want.dtype == np.uint32
            np.testing.assert_array_equal(got, want)
    a, b = t.sketch_codes(genomes[2]), t.sketch_codes(genomes[3])
    assert tfrac.similarity(a, a) == 1.0 and tfrac.similarity(a, b) == jfrac.similarity(a, b)
    assert tfrac.containment(a, b) == jfrac.containment(a, b)
    assert tfrac.similarity(a[:0], a[:0]) == 0.0 and tfrac.containment(a[:0], a) == 0.0
