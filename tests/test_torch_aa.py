"""Amino-acid mode of gsearch_tpu_torch against gsearch_tpu, on the CPU:
sketchers on protein codes (5-bit k-mers, no reverse complement, raw rows
with no per-piece fallback), then `tohnsw --aa` / `add` / `request` through
both CLIs with optdens (bit-exact: byte-identical files) and prob (an f32
log: equal ids, distances within 0.004)."""

import numpy as np
import pytest
import torch

from gsearch_tpu.core.params import SeqSketcherParams as JaxParams
from gsearch_tpu.models import make_sketcher as jax_sketcher
from gsearch_tpu_torch.core.params import SeqSketcherParams
from gsearch_tpu_torch.io.codec import encode_aa
from gsearch_tpu_torch.models import make_sketcher
from test_torch_e2e import run_algo_case, write_algo_corpus

CPU = torch.device("cpu")
EXACT = ("OPTDENS", "REVOPTDENS", "SUPER", "SUPER2")


def _proteomes(rng):
    g = {
        "shorter-than-k": rng.integers(0, 20, size=5).astype(np.uint8),
        "one-block": rng.integers(0, 20, size=9_000).astype(np.uint8),
        "three-pieces": rng.integers(0, 20, size=40_000).astype(np.uint8),
        # separators and unknown residues: invalid codes, many in one piece
        "many-breaks": rng.integers(0, 20, size=36_000).astype(np.uint8),
    }
    g["many-breaks"][rng.random(36_000) < 0.05] = 255
    g["many-breaks"][rng.random(36_000) < 0.01] = 20
    return g


@pytest.mark.parametrize("algo", [*EXACT, "PROB3A", "HLL"])
@pytest.mark.parametrize("k,max_block_log2", [(7, None), (7, 14), (12, 14), (5, None)])
def test_aa_sketchers_against_reference(rng, algo, k, max_block_log2):
    genomes = _proteomes(rng)
    kw = dict(kmer_size=k, sketch_size=256, algo=algo, data_t="AA")
    j, t = jax_sketcher(JaxParams(**kw)), make_sketcher(SeqSketcherParams(**kw), device=CPU)
    assert t.is_aa and j.is_aa
    if max_block_log2:
        j.MAX_BLOCK_LOG2 = t.MAX_BLOCK_LOG2 = max_block_log2
        # amino-acid rows never take the per-piece fallback
        assert [nb for _, nb in t._pieces(genomes["many-breaks"])] == [1 << 14] * 3
    want, got = j.sketch_many(list(genomes.values())), t.sketch_many(list(genomes.values()))
    assert want.dtype == got.dtype == t.SIG_DTYPE
    for i, name in enumerate(genomes):
        if algo in EXACT:
            np.testing.assert_array_equal(got[i].view(np.uint32), want[i].view(np.uint32),
                                          err_msg=f"{algo} {name}")
        else:
            diff = got[i] != want[i]
            assert diff.sum() <= 1, (algo, name, int(diff.sum()))
            if algo == "HLL" and diff.any():
                assert np.abs(got[i].astype(np.int64) - want[i].astype(np.int64))[diff].max() == 1


def test_aa_codes_are_the_references():
    from gsearch_tpu.io.codec import encode_aa as jax_encode_aa

    seq = b"ACDEFGHIKLMNPQRSTVWYacdXBZ*-U\n"
    np.testing.assert_array_equal(encode_aa(seq), jax_encode_aa(seq))


def test_aa_k13_raises_like_reference():
    with pytest.raises(ValueError, match=r"out of range \[1,12\] for AA"):
        SeqSketcherParams(kmer_size=13, sketch_size=64, algo="OPTDENS", data_t="AA")
    # a sketcher built around the parameter check raises the reference's own guard
    p = SeqSketcherParams(kmer_size=12, sketch_size=64, algo="OPTDENS", data_t="AA")
    p.kmer_size = 13
    with pytest.raises(ValueError, match="AA kmer_size must be <= 12"):
        make_sketcher(p, device=CPU)


@pytest.fixture(scope="module")
def aa_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("aa")
    return root, write_algo_corpus(root, is_aa=True, seed=17)


@pytest.mark.parametrize("algo", ["optdens", "prob"])
def test_aa_end_to_end_both_packages(aa_corpus, tmp_path, algo):
    root, ext = aa_corpus
    assert ext == "faa"
    run_algo_case(root, tmp_path, algo, True, ext)


def test_aa_sequence_mode_both_packages(tmp_path, monkeypatch):
    """Without `--block` every protein record is its own database entry:
    both CLIs write the same database, neighbours file and matches file."""
    from gsearch_tpu.cli.main import main as jax_main
    from gsearch_tpu_torch.cli.main import main as torch_main

    rng = np.random.default_rng(5)
    alpha = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    (tmp_path / "db").mkdir()
    (tmp_path / "q").mkdir()
    prots = [rng.choice(alpha, 900) for _ in range(9)]
    for f in range(3):
        body = b"".join(b">f%d_p%d\n" % (f, i) + prots[3 * f + i].tobytes() + b"\n" for i in range(3))
        (tmp_path / "db" / f"f{f}.faa").write_bytes(body + b">tiny\nACD\n")  # shorter than k: skipped
    q = prots[4].copy()
    q[rng.choice(900, 20, replace=False)] = alpha[0]
    (tmp_path / "q" / "q.faa").write_bytes(b">q0\n" + q.tobytes() + b"\n>q1\n" + prots[8].tobytes() + b"\n")
    monkeypatch.chdir(tmp_path)
    build = ["-k", "6", "-s", "256", "-n", "8", "--ef", "64", "--algo", "optdens", "--aa"]
    for pkg, run, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        assert run(["tohnsw", "-d", "db", *build, "-o", f"db_{pkg}", *extra]) == 0
        assert run(["request", "-b", f"db_{pkg}", "-n", "3", "-r", "q", "-o", f"out_{pkg}", *extra]) == 0
    for name in ("index.sigs.npy", "index.meta.json", "seqdict.json", "parameters.json"):
        assert (tmp_path / "db_jax" / name).read_bytes() == (tmp_path / "db_torch" / name).read_bytes(), name
    assert np.load(tmp_path / "db_torch" / "index.sigs.npy").shape == (9, 256)
    for name in ("gsearch.neighbors.txt", "gsearch.matches"):
        assert (tmp_path / "out_jax" / name).read_bytes() == (tmp_path / "out_torch" / name).read_bytes(), name
    text = (tmp_path / "out_torch" / "gsearch.neighbors.txt").read_text()
    assert "f1_p1" in text and "f2_p2" in text
