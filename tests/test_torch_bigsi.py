"""gsearch_tpu_torch's BIGSI index (index/bigsi.py, the bigsig tool) and its
FASTQ readers against gsearch_tpu's, on the CPU.

Tolerances: none.  Positions, validity, bit matrices, counts and the
written files are integers or formatted from the same float64 host
arithmetic, so every comparison is exact.  Parity runs with 1 and 2 hashes:
gsearch_tpu raises for 3 or more (its hash seed leaves 32 bits), so the
port's 3-hash index is held to a numpy recomputation instead."""

import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsearch_tpu.cli.bigsig import main as jax_bigsig
from gsearch_tpu.index.bigsi import BigsiIndex as JaxBigsi
from gsearch_tpu.io import fasta as jax_fasta
from gsearch_tpu_torch.cli.main import main as torch_main
from gsearch_tpu_torch.index.bigsi import BigsiIndex, hash_seed, window_min_same
from gsearch_tpu_torch.io import fasta as torch_fasta

CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)
M32 = 0xFFFFFFFF


def _codes(rng, n):
    return rng.integers(0, 4, n).astype(np.uint8)


def _with_n_runs(rng, g):
    g = g.copy()
    for start in rng.integers(0, max(len(g) - 60, 1), 4):
        g[start : start + int(rng.integers(5, 50))] = 255
    return g


@pytest.mark.parametrize("w", [0, 4, 5, 16])
@pytest.mark.parametrize("k", [15, 21, 31])
def test_positions_and_validity(k, w):
    """Every position (invalid windows included) and the validity mask, on
    a block with N runs and stray codes; minimizer windows odd and even."""
    rng = np.random.default_rng(k * 100 + w)
    nb = 1 << 14
    codes = _with_n_runs(rng, _codes(rng, nb))
    codes[rng.integers(0, nb, 20)] = 7
    short = np.full(nb, 255, np.uint8)
    short[: k - 1] = _codes(rng, k - 1)  # a genome shorter than k
    ref = JaxBigsi(1 << 20, 2, k, w)
    port = BigsiIndex(1 << 20, 2, k, w, device=CPU)
    one = BigsiIndex(1 << 20, 1, k, w, device=CPU)  # hash 0 alone: the same seed
    for c in (codes, short):
        want_p, want_v = ref._positions_fn(nb)(jnp.asarray(c))
        got_p, got_v = port.positions(torch.from_numpy(c))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p).astype(np.int64))
        p1, v1 = one.positions(torch.from_numpy(c))
        assert torch.equal(p1, got_p[:1]) and torch.equal(v1, got_v)
    assert not got_v.any()


@pytest.mark.parametrize("w", [1, 2, 3, 4, 7, 16])
def test_window_min_matches_xla_same(w):
    """The minimizer window against jax.lax.reduce_window(min, SAME) on rows."""
    import jax

    rng = np.random.default_rng(w)
    h = rng.integers(0, 1 << 32, (3, 50), dtype=np.uint64).astype(np.uint32)
    want = jax.lax.reduce_window(jnp.asarray(h), jnp.uint32(M32), jax.lax.min, (1, w), (1, 1), "SAME")
    got = window_min_same(torch.from_numpy(h.astype(np.int64)), w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def _insert_all(idx, genomes):
    for i, g in enumerate(genomes):
        idx.insert_genome(f"g{i}", g)
    return idx


@pytest.mark.parametrize("w", [0, 5])
def test_bit_matrix_grows_past_32_columns(w):
    """34 genomes (the word count grows at genome 32): N runs, an empty and
    a shorter-than-k genome among them; the same words and fill counts."""
    rng = np.random.default_rng(11 + w)
    lengths = [*rng.integers(3_000, 16_000, 5), 40_000]  # two block lengths
    genomes = [_with_n_runs(rng, _codes(rng, int(n))) for n in lengths]
    small = [_codes(rng, 500) for _ in range(26)] + [_codes(rng, 10), np.empty(0, np.uint8)]
    order = genomes[:4] + small + genomes[4:]
    ref = _insert_all(JaxBigsi(1 << 18, 2, 21, w), order)
    port = _insert_all(BigsiIndex(1 << 18, 2, 21, w, device=CPU), order)
    assert port._bits.shape == (1 << 18, 2) and port._bits.dtype == np.uint32
    np.testing.assert_array_equal(port._bits, ref._bits)
    assert port._ones_per_genome == ref._ones_per_genome
    assert port.names == ref.names
    np.testing.assert_array_equal(port.fp_rates(), ref.fp_rates())


def test_genome_across_the_piece_boundary():
    """A genome past 2^22 bases goes in pieces overlapping by k - 1."""
    rng = np.random.default_rng(5)
    g = _codes(rng, (1 << 22) + 3_000)
    g[(1 << 22) - 10 : (1 << 22) + 10] = _codes(rng, 20)
    ref = _insert_all(JaxBigsi(1 << 20, 2, 21), [g])
    port = _insert_all(BigsiIndex(1 << 20, 2, 21, device=CPU), [g])
    np.testing.assert_array_equal(port._bits, ref._bits)
    assert port._ones_per_genome == ref._ones_per_genome


def _reads(rng, genomes, n, read_len):
    """Substrings of the genomes (some shorter than read_len, padded with
    invalid codes), some with N runs, and random reads."""
    out = np.full((n, read_len), 255, np.uint8)
    for i in range(n):
        ln = read_len if i % 5 else int(rng.integers(10, read_len))
        if i % 7 == 3:
            out[i, :ln] = _codes(rng, ln)
            continue
        g = genomes[i % len(genomes)]
        s = int(rng.integers(0, len(g) - ln))
        out[i, :ln] = g[s : s + ln]
    out[4, 30:40] = 255
    return out


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(21)
    genomes = [_with_n_runs(rng, _codes(rng, int(n))) for n in (20_000, 35_000, 50_000, 8_000)]
    reads = _reads(rng, genomes, 60, 150)
    mates = _reads(rng, genomes, 60, 150)
    return genomes, reads, mates


@pytest.fixture(scope="module")
def indexes(corpus):
    """(gsearch_tpu's, the port's) index over the corpus by (h, w), built once."""
    built = {}

    def get(h, w):
        if (h, w) not in built:
            built[h, w] = (_insert_all(JaxBigsi(1 << 17, h, 21, w), corpus[0]),
                           _insert_all(BigsiIndex(1 << 17, h, 21, w, device=CPU), corpus[0]))
        return built[h, w]
    return get


@pytest.mark.parametrize("mode", ["plain", "minimizer", "down_sample", "paired"])
@pytest.mark.parametrize("h", [1, 2])
def test_raw_counts(corpus, indexes, mode, h):
    """Reads shorter than the batch's length padded with invalid codes."""
    _, reads, mates = corpus
    ref, port = indexes(h, 6 if mode == "minimizer" else 0)
    d = 3 if mode == "down_sample" else 1
    want_c, want_t = ref.raw_counts(reads, down_sample=d)
    got_c, got_t = port.raw_counts(reads, down_sample=d)
    if mode == "paired":
        c2, t2 = ref.raw_counts(mates)
        g2, u2 = port.raw_counts(mates)
        want_c, want_t, got_c, got_t = want_c + c2, want_t + t2, got_c + g2, got_t + u2
    assert got_c.dtype == np.int32 and got_c.shape == (60, 4)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_t, want_t)
    assert (got_c.max(1) > 0).sum() > 30


@pytest.mark.parametrize("fp_exponent", [0.0, 3.0])
def test_score_counts(corpus, indexes, fp_exponent):
    reads = corpus[1]
    ref, port = indexes(2, 0)
    counts, totals = port.raw_counts(reads)
    for frac in (0.3, 0.7):
        want = ref.score_counts(counts, totals, frac, fp_exponent)
        assert port.score_counts(counts, totals, frac, fp_exponent) == want
        assert port.classify(reads, frac, fp_exponent=fp_exponent) == want
    assert sum(map(bool, want)) > 20


def test_save_and_load_across_packages(corpus, indexes, tmp_path):
    reads = corpus[1]
    ref, port = indexes(2, 6)
    ref.save(str(tmp_path / "a"))
    port.save(str(tmp_path / "b"))
    assert (tmp_path / "a.bigsi.json").read_text() == (tmp_path / "b.bigsi.json").read_text()
    got = BigsiIndex.load(str(tmp_path / "a"), device=CPU)
    back = JaxBigsi.load(str(tmp_path / "b"))
    for idx in (got, back, BigsiIndex.from_jax(ref, device=CPU)):
        np.testing.assert_array_equal(idx._bits, ref._bits)
        assert idx._ones_per_genome == ref._ones_per_genome and idx.names == ref.names
        assert (idx.minimizer_window, idx.seed, idx.kmer_size) == (6, 0x5EED, 21)
    for a, b in zip(ref.raw_counts(reads), got.raw_counts(reads)):
        np.testing.assert_array_equal(a, b)


def _np_mix32(x, seed):
    x = (x ^ np.uint32(seed)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x7FEB352D)).astype(np.uint32)
    x ^= x >> np.uint32(15)
    x = (x * np.uint32(0x846CA68B)).astype(np.uint32)
    return x ^ (x >> np.uint32(16))


def _np_positions(codes, k, seed, j, bloom):
    """Canonical 2-bit k-mers as u64, split into (hi, lo), mixed by mix2."""
    n = len(codes) - k + 1
    fwd = np.zeros(n, np.uint64)
    rev = np.zeros(n, np.uint64)
    for i in range(k):
        c = codes[i : i + n].astype(np.uint64)
        fwd = (fwd << np.uint64(2)) | c
        rev |= (np.uint64(3) - c) << np.uint64(2 * i)
    canon = np.minimum(fwd, rev)
    hi = (canon >> np.uint64(32)).astype(np.uint32)
    lo = (canon & np.uint64(M32)).astype(np.uint32)
    s = hash_seed(seed, j)
    a = _np_mix32(lo, s ^ 0x9E3779B9)
    b = _np_mix32(hi ^ a, s)
    return _np_mix32(a ^ b, s ^ 0x85EBCA6B).astype(np.int64) % bloom


def test_three_hashes_port_only():
    """gsearch_tpu raises for a third hash (seed j * 0x9E3779B9 past 32
    bits); the port reduces the seed to 32 bits, which is the reference's
    seed for j <= 1, and sets exactly the three numpy position streams."""
    rng = np.random.default_rng(17)
    g = _codes(rng, 30_000)
    with pytest.raises(OverflowError):
        JaxBigsi(1 << 16, 3, 21).insert_genome("g", g)
    assert hash_seed(0x5EED, 1) == 0x5EED ^ 0xB165B165 ^ 0x9E3779B9
    assert hash_seed(0x5EED, 2) == (0x5EED ^ 0xB165B165 ^ (2 * 0x9E3779B9)) & M32
    port = BigsiIndex(1 << 16, 3, 21, device=CPU)
    pos, valid = port.positions(torch.from_numpy(g))
    n = len(g) - 20
    assert valid[:n].all() and not valid[n:].any()
    want = np.unique(np.concatenate([_np_positions(g, 21, 0x5EED, j, 1 << 16) for j in range(3)]))
    for j in range(3):
        np.testing.assert_array_equal(pos[j, :n].numpy(), _np_positions(g, 21, 0x5EED, j, 1 << 16))
    port.insert_genome("g", g)
    assert port._ones_per_genome == [len(want)]
    assert set(np.nonzero(port._bits[:, 0])[0]) == set(want.tolist())
    read = g[1000:1200][None, :]
    counts, totals = port.raw_counts(read)
    assert counts[0, 0] == totals[0] == 180


def _fastq(recs, rng, low_q=0.1):
    lines = []
    for name, seq in recs:
        q = np.full(len(seq), ord("I"), np.uint8)
        q[rng.random(len(seq)) < low_q] = ord("#")
        lines.append(b"@%s extra\n%s\n+\n%s\n" % (name.encode(), seq, q.tobytes()))
    return b"".join(lines)


def test_fastq_readers(tmp_path):
    rng = np.random.default_rng(3)
    recs = [(f"r{i}", ACGT[rng.integers(0, 4, int(n))].tobytes()) for i, n in enumerate((5, 80, 130))]
    data = _fastq(recs, rng)
    (tmp_path / "r.fq.gz").write_bytes(gzip.compress(data))
    (tmp_path / "r.fastq").write_bytes(data)
    (tmp_path / "r.fa").write_bytes(b"".join(b">%s\n%s\n" % (n.encode(), s) for n, s in recs))
    for name in ("r.fq.gz", "r.fastq", "r.fa", "x.fastq.zst", "y.fna"):
        assert torch_fasta.is_fastq_file(name) == jax_fasta.is_fastq_file(name)
    for name in ("r.fq.gz", "r.fastq", "r.fa"):
        for q in (0, 15, 41):
            want = list(jax_fasta.parse_reads(str(tmp_path / name), quality_min=q))
            got = list(torch_fasta.parse_reads(str(tmp_path / name), quality_min=q))
            assert [(r.fasta_id, r.seq, r.header) for r in got] == \
                   [(r.fasta_id, r.seq, r.header) for r in want]
    masked = list(torch_fasta.parse_fastq(data=data, quality_min=15))
    assert any(b"N" in r.seq for r in masked)


@pytest.mark.parametrize("fmt", ["fasta", "fastq.gz"])
@pytest.mark.parametrize("paired", [False, True])
def test_bigsig_cli_files_identical(tmp_path, fmt, paired):
    """construct + identify through both CLIs: the index files load alike
    and _reads.txt / _counts.txt are byte-identical (FASTQ quality mask on,
    reads shorter and longer than --read_len, random reads among them)."""
    rng = np.random.default_rng(7)
    refs = tmp_path / "refs"
    refs.mkdir()
    genomes = []
    for i, n in enumerate((30_000, 45_000, 25_000)):
        g = ACGT[rng.integers(0, 4, n)].tobytes()
        genomes.append(g)
        (refs / f"g{i}.fna").write_bytes(b">g%d desc\n%s\n" % (i, g))
    build = ["--bloom", "300000", "-k", "21", "-m", "0" if fmt == "fasta" else "4"]
    assert jax_bigsig(["construct", "-r", str(refs), "-b", str(tmp_path / "jx"), *build]) == 0
    assert torch_main(["bigsig", "construct", "-r", str(refs), "-b", str(tmp_path / "pt"),
                       *build, "--device", "cpu"]) == 0
    assert (tmp_path / "jx.bigsi.json").read_text() == (tmp_path / "pt.bigsi.json").read_text()
    with np.load(tmp_path / "jx.bigsi.npz") as a, np.load(tmp_path / "pt.bigsi.npz") as b:
        np.testing.assert_array_equal(a["bits"], b["bits"])
        np.testing.assert_array_equal(a["ones"], b["ones"])

    files = []
    for mate in range(2 if paired else 1):
        recs = []
        for r in range(70):
            ln = int(rng.integers(60, 200))
            if r % 9 == 4:
                seq = ACGT[rng.integers(0, 4, ln)].tobytes()
            else:
                g = genomes[r % 3]
                s = int(rng.integers(0, len(g) - ln))
                seq = g[s : s + ln]
            recs.append((f"read{r}/{mate + 1}", seq))
        if fmt == "fasta":
            path = tmp_path / f"r{mate}.fa"
            path.write_bytes(b"".join(b">%s\n%s\n" % (n.encode(), s) for n, s in recs))
        else:
            path = tmp_path / f"r{mate}.fq.gz"
            path.write_bytes(gzip.compress(_fastq(recs, rng, low_q=0.03)))
        files.append(str(path))
    ident = ["--read_len", "150", "--batch", "32", "--min_fraction", "0.6", "-c", "2.0"]
    assert jax_bigsig(["identify", "-b", str(tmp_path / "jx"), "-q", *files,
                       "-o", str(tmp_path / "out_j"), *ident]) == 0
    assert torch_main(["bigsig", "identify", "-b", str(tmp_path / "jx"), "-q", *files,
                       "-o", str(tmp_path / "out_p"), *ident, "--device", "cpu"]) == 0
    for suffix in ("_reads.txt", "_counts.txt"):
        want = (tmp_path / f"out_j{suffix}").read_text()
        assert (tmp_path / f"out_p{suffix}").read_text() == want, suffix
    assert want.count("\tgenome\n") == 3 and "unclassified" in want
    assert len((tmp_path / "out_j_reads.txt").read_text().splitlines()) > 50
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            torch_main(["bigsig", "identify", "-b", str(tmp_path / "pt"), "-q", *files])
    assert os.path.exists(tmp_path / "pt.bigsi.npz")
