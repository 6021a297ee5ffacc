"""gsearch_tpu_torch's seed chaining (models/seedchain.py, the superani tool)
against gsearch_tpu's, on the CPU.

Tolerances: none.  The seeds are integer hashes of canonical k-mers
thinned by an integer threshold, so hashes and positions are bit-exact
(a genome past the 2^22-base block included: its pieces overlap by
k - 1); chaining, ANI and aligned fractions are the same host numpy on
the same anchors, so `compare` returns equal floats and the TSVs are
byte-identical, with the raw ANI (`--model none`) and with the bundled
regression."""

import numpy as np
import pytest
import torch

from gsearch_tpu.cli.superani import run_superani as jax_superani
from gsearch_tpu.models.seedchain import AniRegression as JaxRegression
from gsearch_tpu.models.seedchain import SeedChainer as JaxChainer
from gsearch_tpu_torch.cli.main import main as torch_main
from gsearch_tpu_torch.models.seedchain import AniRegression, SeedChainer

CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _mutate(rng, g, rate):
    out = g.copy()
    hit = rng.random(out.size) < rate
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return out.astype(np.uint8)


@pytest.fixture(scope="module")
def genomes():
    """A 200 kb reference, a point-mutation ladder of it, a fragmented copy
    (contigs with gaps, joined by separators), a rearranged copy (block
    swap), an N-run genome and short ones."""
    rng = np.random.default_rng(31)
    ref = rng.integers(0, 4, 200_000).astype(np.uint8)
    out = {"ref": ref}
    for rate in (0.005, 0.02, 0.05):
        out[f"mut{rate}"] = _mutate(rng, ref, rate)
    cuts = np.sort(rng.choice(np.arange(1000, 199_000), 18, replace=False)).reshape(-1, 2)
    contigs = [ref[a:b] for a, b in cuts] + [ref[:500]]
    out["fragmented"] = np.concatenate(
        [np.concatenate([c, np.array([255], np.uint8)]) for c in contigs])[:-1]
    out["rearranged"] = _mutate(rng, np.concatenate([ref[120_000:], ref[:120_000]]), 0.01)
    nrun = ref.copy()
    nrun[5000:9000] = 255
    out["nrun"] = nrun
    out["tiny"] = ref[:20]
    out["empty"] = ref[:0]
    return out


def test_sketch_bit_exact(genomes):
    ref_ch, got_ch = JaxChainer(k=16, c=30), SeedChainer(k=16, c=30, device=CPU)
    for name, g in genomes.items():
        want, have = ref_ch.sketch(g), got_ch.sketch(g)
        assert have.hashes.dtype == want.hashes.dtype == np.uint32, name
        np.testing.assert_array_equal(have.hashes, want.hashes, err_msg=name)
        np.testing.assert_array_equal(have.positions, want.positions, err_msg=name)
        assert (have.length, have.c) == (want.length, want.c), name


def test_sketch_across_the_block_bit_exact():
    """A genome longer than 1 << 22 bases is sketched in two pieces."""
    rng = np.random.default_rng(32)
    g = rng.integers(0, 4, (1 << 22) + 200_000).astype(np.uint8)
    g[(1 << 22) - 40 : (1 << 22) + 10] = rng.integers(0, 4, 50)  # seeds across the seam
    want = JaxChainer(k=16, c=30).sketch(g)
    have = SeedChainer(k=16, c=30, device=CPU).sketch(g)
    np.testing.assert_array_equal(have.hashes, want.hashes)
    np.testing.assert_array_equal(have.positions, want.positions)
    assert (want.positions > (1 << 22) - 16).sum() > 1000


@pytest.mark.parametrize("model", ["none", None])
def test_compare_equal(genomes, model):
    ref_ch = JaxChainer(k=16, c=30, regression=JaxRegression.load(model))
    got_ch = SeedChainer(k=16, c=30, regression=AniRegression.load(model), device=CPU)
    sk_ref = {k: ref_ch.sketch(g) for k, g in genomes.items()}
    sk_got = {k: got_ch.sketch(g) for k, g in genomes.items()}
    for q in genomes:
        want = ref_ch.compare(sk_ref[q], sk_ref["ref"])
        assert got_ch.compare(sk_got[q], sk_got["ref"]) == want, q
    raw = got_ch.compare(sk_got["mut0.02"], sk_got["ref"])
    if model == "none":
        assert abs(raw[0] - 100 * (1 - 0.02)) < 0.5
    assert got_ch.compare(sk_got["rearranged"], sk_got["ref"])[0] > 97.0
    assert AniRegression.load("none").predict(97.0, 0.8) == 97.0
    assert AniRegression.load(None).predict(97.0, 0.8) == JaxRegression.load(None).predict(97.0, 0.8)


@pytest.mark.parametrize("model", [[], ["--model", "none"]], ids=["bundled", "none"])
def test_superani_tsv_identical(genomes, tmp_path, model):
    paths = {}
    for name in ("ref", "mut0.005", "fragmented", "rearranged"):
        p = tmp_path / f"{name}.fna"
        p.write_bytes(b">" + name.encode() + b"\n" + np.where(genomes[name] < 4, ACGT[genomes[name] % 4],
                                                              ord("N")).astype(np.uint8).tobytes() + b"\n")
        paths[name] = str(p)
    (tmp_path / "copy").mkdir()
    dup = tmp_path / "copy" / "ref.fna"  # same basename as a query: 100 / 1 / 1
    dup.write_bytes((tmp_path / "ref.fna").read_bytes())
    ql, rl = tmp_path / "q.txt", tmp_path / "r.txt"
    ql.write_text("\n".join(paths.values()) + "\n")
    rl.write_text(f"{paths['ref']}\n{dup}\n{paths['fragmented']}\n")
    jax_superani(str(ql), str(rl), output=str(tmp_path / "jax.tsv"),
                 model=model[1] if model else None)
    assert torch_main(["superani", "-q", str(ql), "-r", str(rl), "-o", str(tmp_path / "torch.tsv"),
                       *model, "--device", "cpu"]) == 0
    want = (tmp_path / "jax.tsv").read_bytes()
    assert (tmp_path / "torch.tsv").read_bytes() == want
    assert want.count(b"\n") == 1 + 4 * 3 and b"\t100.0000\t1.0000\t1.0000\n" in want
