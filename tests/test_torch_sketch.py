"""gsearch_tpu_torch OptDens / RevOptDens signatures against gsearch_tpu:
bit-exact, on every row partition the reference uses.

The reference's partition of a long genome depends on its upload form; it
is pinned here to the packed exception form (`_upload_raw = False`, the
default wherever its native packer loads), the form the port follows."""

import numpy as np
import pytest
import torch

from gsearch_tpu.core.params import SeqSketcherParams as JaxParams
from gsearch_tpu.io.codec import PackedCodes as JaxPackedCodes
from gsearch_tpu.models import make_sketcher as jax_sketcher
from gsearch_tpu_torch.core.params import SeqSketcherParams
from gsearch_tpu_torch.io.codec import PackedCodes
from gsearch_tpu_torch.models import make_sketcher
from gsearch_tpu_torch.models.base import block_length

CPU = torch.device("cpu")


def torch_sketcher(params):
    return make_sketcher(params, device=CPU)


def _packed(codes: np.ndarray) -> PackedCodes:
    n = len(codes)
    valid = codes < 4
    c = np.zeros(4 * ((n + 3) // 4), np.uint8)
    c[:n] = np.where(valid, codes, 0)
    p2 = c[0::4] | (c[1::4] << 2) | (c[2::4] << 4) | (c[3::4] << 6)
    return PackedCodes(p2, n, np.nonzero(~valid)[0].astype(np.int32))


def _ref(genomes):
    """The genomes as the reference's sketcher takes them: its own
    PackedCodes class in place of the port's."""
    return [JaxPackedCodes(g.p2, g.n, g.inv) if isinstance(g, PackedCodes) else g for g in genomes]


def _with_n_runs(rng, n, runs, run_len, lo=0, hi=None):
    g = rng.integers(0, 4, size=n).astype(np.uint8)
    for st in rng.integers(lo, (hi or n) - run_len, runs):
        g[st : st + run_len] = 255
    return g


def _pair(algo, s, max_block_log2=None):
    """The reference's and the port's sketcher, each built from its own
    package's parameters."""
    kw = dict(kmer_size=16, sketch_size=s, algo=algo, data_t="DNA")
    j, t = jax_sketcher(JaxParams(**kw)), torch_sketcher(SeqSketcherParams(**kw))
    j._upload_raw = False
    if max_block_log2 is not None:
        j.MAX_BLOCK_LOG2 = t.MAX_BLOCK_LOG2 = max_block_log2
    return j, t


def _assert_rows_equal(a: np.ndarray, b: np.ndarray, names):
    assert a.dtype == b.dtype == np.float32
    for i, name in enumerate(names):
        np.testing.assert_array_equal(a[i].view(np.uint32), b[i].view(np.uint32), err_msg=name)


# OptDens at s=128 gates the windowed pre-reduce on (16384-base rows);
# RevOptDens at s=1024 leaves it off
@pytest.mark.parametrize("algo,s", [("OPTDENS", 128), ("REVOPTDENS", 1024)])
def test_sketch_many_multiblock_bit_exact(rng, algo, s):
    """Blocks of 16,384 bases (MAX_BLOCK_LOG2=14): genomes shorter than k,
    one block, several pieces, and N-run-heavy rows, as code arrays and as
    PackedCodes (whose pieces start 4-aligned)."""
    genomes = {
        "shorter-than-k": rng.integers(0, 4, size=10).astype(np.uint8),
        "one-block": rng.integers(0, 4, size=12_000).astype(np.uint8),
        "two-pieces": rng.integers(0, 4, size=33_000).astype(np.uint8),
        "five-pieces": rng.integers(0, 4, size=70_001).astype(np.uint8),
        # > 1024 invalid positions in one piece: per-piece block buckets
        "n-runs-long": _with_n_runs(rng, 40_000, 30, 60, hi=16_000),
    }
    names = list(genomes)
    j, t = _pair(algo, s, max_block_log2=14)
    codes = list(genomes.values())
    _assert_rows_equal(j.sketch_many(_ref(codes)), t.sketch_many(codes), names)
    packed = [_packed(c) for c in codes]
    _assert_rows_equal(j.sketch_many(_ref(packed)), t.sketch_many(packed), names)
    # an N-run-heavy short genome sends the reference's whole batch down its
    # bit-plane path, whose rows are padded with uninitialised bytes: only a
    # batch of one genome that fills its block exactly is deterministic there
    heavy = _with_n_runs(rng, 16_384, 25, 80)
    for g in (heavy, _packed(heavy)):
        _assert_rows_equal(j.sketch_many(_ref([g])), t.sketch_many([g]), ["n-runs-full-block"])


def test_sketch_codes_and_default_block_bit_exact(rng):
    """Default blocks (MAX_BLOCK_LOG2=22): a 1.5x-midpoint bucket, and an
    N-run-heavy genome through sketch_codes (padded with invalid codes)."""
    one = rng.integers(0, 4, size=20_000).astype(np.uint8)
    heavy = _with_n_runs(rng, 12_000, 25, 60)
    assert block_length(len(one)) == 24_576
    j, t = _pair("OPTDENS", 512)
    for name, g in (("midpoint-bucket", one), ("n-runs-padded", heavy)):
        np.testing.assert_array_equal(j.sketch_codes(_ref([g])[0]).view(np.uint32),
                                      t.sketch_codes(g).view(np.uint32), err_msg=name)


def test_n_heavy_long_genome_takes_per_piece_buckets(rng):
    """With 32,768-base blocks a long genome's last piece gets its own
    16,384 bucket when a piece is N-run-heavy (the reference's fallback)
    and a full block otherwise; both partitions are bit-exact."""
    clean = rng.integers(0, 4, size=40_000).astype(np.uint8)
    heavy = _with_n_runs(rng, 40_000, 30, 60, hi=30_000)
    j, t = _pair("OPTDENS", 128, max_block_log2=15)
    assert [nb for _, nb in t._pieces(clean)] == [32_768, 32_768]
    assert [nb for _, nb in t._pieces(heavy)] == [32_768, 16_384]
    assert [nb for _, nb in t._pieces(_packed(heavy))] == [32_768, 16_384]
    genomes = [clean, heavy]
    _assert_rows_equal(j.sketch_many(_ref(genomes)), t.sketch_many(genomes), ["clean", "heavy"])
    packed = [_packed(g) for g in genomes]
    _assert_rows_equal(j.sketch_many(_ref(packed)), t.sketch_many(packed), ["clean", "heavy"])


def test_submit_finish_tickets_independent(rng):
    """Two tickets in flight, finished in reverse order, equal sketch_many."""
    _, t = _pair("OPTDENS", 256, max_block_log2=14)
    a = [rng.integers(0, 4, size=n).astype(np.uint8) for n in (5_000, 40_000)]
    b = [rng.integers(0, 4, size=n).astype(np.uint8) for n in (900, 16_384, 20_000)]
    ta, tb = t.sketch_submit(a), t.sketch_submit(b)
    got_b, got_a = t.sketch_finish(tb), t.sketch_finish(ta)
    np.testing.assert_array_equal(got_a, t.sketch_many(a))
    np.testing.assert_array_equal(got_b, t.sketch_many(b))
    assert t.sketch_many([]).shape == (0, 256)


def test_unported_sketchers_raise():
    """Every algorithm and amino-acid mode is ported: what still raises is
    what the reference refuses too (an unknown algorithm, AA k > 12)."""
    for algo in ("PROB3A", "SUPER", "SUPER2", "HLL"):
        for data_t, k in (("DNA", 16), ("AA", 7)):
            sk = torch_sketcher(SeqSketcherParams(kmer_size=k, sketch_size=64, algo=algo, data_t=data_t))
            assert sk.sketch_many([]).shape == (0, 64)
    with pytest.raises(ValueError, match="NONSENSE"):
        SeqSketcherParams(kmer_size=16, sketch_size=64, algo="NONSENSE", data_t="DNA")
    with pytest.raises(ValueError, match=r"out of range \[1,12\] for AA"):
        SeqSketcherParams(kmer_size=13, sketch_size=64, algo="OPTDENS", data_t="AA")
