"""The plain references: the k-NN against a brute-force numpy search, the
sketcher against a hand-checked tiny genome and against the program's CPU
sketcher (pieces, the windowed pre-reduce, N-run-heavy rows)."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench.corpora import genomes  # noqa: E402
from portbench.reference import knn, sketch  # noqa: E402
from pbcommon import INGEST_TRAFFIC, small_blocks  # noqa: E402

torch.set_num_threads(2)
M32 = 0xFFFFFFFF


def test_exact_knn_matches_brute_force_numpy():
    rng = np.random.default_rng(3)
    db = rng.integers(0, 4, (700, 96)).astype(np.int32)      # many equal slots and ties
    q = rng.integers(0, 4, (9, 96)).astype(np.int32)
    ref = knn.ExactKnn(db, "cpu", buffer_bytes=1 << 16)       # many blocks
    eq = (db[None] == q[:, None]).sum(-1)
    order = np.lexsort((np.broadcast_to(np.arange(700), eq.shape), -eq), axis=1)[:, :10]
    got_eq, got_ids = ref.top(q, 10)
    assert np.array_equal(got_ids, order)
    assert np.array_equal(got_eq, np.take_along_axis(eq, order, 1))
    assert np.array_equal(ref.eq_of(q, order), np.take_along_axis(eq, order, 1))
    d, ids = ref.search(q, 10)
    assert np.allclose(d, 1 - np.take_along_axis(eq, order, 1) / 96, atol=1e-7)


def test_hashed_knn_compares_byte_hashes():
    rng = np.random.default_rng(4)
    db = rng.integers(-2**31, 2**31, (300, 64)).astype(np.int32)
    ref8 = knn.ExactKnn(db, "cpu", hashed=8)
    h = ((db.astype(np.int64) & M32) * 0x9E3779B1 & M32) >> 24
    eq = (h[None, :5] == h[:5, None]).sum(-1)
    assert np.array_equal(ref8.eq_of(db[:5], np.tile(np.arange(5), (5, 1))), eq)


def _mix32(x, seed):
    x = (x ^ seed) & M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def _mix2(hi, lo, seed):
    a = _mix32(lo, seed ^ 0x9E3779B9)
    b = _mix32(hi ^ a, seed)
    return _mix32(a ^ b, seed ^ 0x85EBCA6B)


def test_tiny_sketch_by_hand():
    """24 bases, k = 4, S = 8: each k-mer's canonical code, slot and word
    by Python integers, the least word a slot, then the densification."""
    seq = b"ACGTTGCAAACCNGGTTTACGATG"
    codes = np.frombuffer(seq, np.uint8)
    codes = np.where(codes == ord("N"), 255, np.searchsorted(np.frombuffer(b"ACGT", np.uint8), codes)).astype(np.uint8)
    k, s, seed = 4, 8, sketch.SEED
    darts = []
    for i in range(len(codes) - k + 1):
        win = codes[i : i + k]
        if (win > 3).any():
            continue
        fwd = sum(int(c) << 2 * (k - 1 - j) for j, c in enumerate(win))
        rev = sum((3 - int(c)) << 2 * j for j, c in enumerate(win))
        can = min(fwd, rev)
        slot = _mix2(0, can, seed ^ sketch.SLOT_SEED) % s
        key = _mix2(0, can, seed ^ sketch.KEY_SEED)
        darts.append((i, (key & (M32 ^ 0xF)) | slot))  # 4 slot bits for S = 8
    # the row is the smallest block (2^14 >= 24 bases): gated, so each
    # window of 32 positions keeps its 6 smallest distinct words
    kept = []
    for w in range(0, 1 << 14, 32):
        kept += sorted({d for i, d in darts if w <= i < w + 32})[:6]
    words = [M32] * s
    for d in kept:
        words[d & 0xF] = min(words[d & 0xF], d)
    assert len(kept) < len(darts)
    found = [w != M32 for w in words]
    out, empty = [w if f else 0 for w, f in zip(words, found)], [not f for f in found]
    for r in range(sketch.DENS_ROUNDS):
        for i in range(s):
            t = _mix32(i, seed ^ sketch.DENS_FAMILY ^ (r * 0x9E37)) % s
            if empty[i] and found[t]:
                out[i] = words[t]
                empty[i] = False
    least = min(w for w in words if w != M32)
    out = [_mix32(i ^ least, seed ^ sketch.FILLER_SEED) if e else o for i, (o, e) in enumerate(zip(out, empty))]
    got = sketch.sketch_words(codes, k=k, s=s, device="cpu").tolist()
    assert got == out


@pytest.mark.parametrize("sketch_size", [512, 600, 4096])
def test_sketch_matches_the_program_on_pieces_and_n_runs(tmp_path, monkeypatch, sketch_size):
    from gsearch_tpu_torch.core.params import SeqSketcherParams
    from gsearch_tpu_torch.io.fasta import concat_file_codes_packed
    from gsearch_tpu_torch.models import make_sketcher

    small_blocks(monkeypatch)
    corpus = genomes.write(str(tmp_path), dict(INGEST_TRAFFIC, gzip_level=1), 99)
    sk = make_sketcher(SeqSketcherParams(kmer_size=16, sketch_size=sketch_size, algo="OPTDENS",
                                         data_t="DNA"), device=torch.device("cpu"))
    heavy = gated = 0
    for path in corpus["files"]:
        codes = sketch.read_genome(path)
        rows = sketch.pieces(codes, 16)
        heavy += any(nb < 1 << 16 for _, nb in rows) and len(rows) > 1
        gated += any(nb % 32 == 0 and nb // 2 / sketch_size >= 40 for _, nb in rows)
        want = sk.sketch_codes(concat_file_codes_packed(path)[0])
        got = sketch.sketch(codes, k=16, s=sketch_size, device="cpu")
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), path
    assert heavy  # an N-run-heavy genome cut into per-piece buckets
    assert gated or sketch_size == 4096


def test_bf16_control_changes_the_slots():
    sig = np.random.default_rng(1).random(1000, dtype=np.float32)
    assert (sketch.round_bf16(sig).view(np.int32) != sig.view(np.int32)).mean() > 0.99
