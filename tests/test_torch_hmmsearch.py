"""gsearch_tpu_torch's profile-HMM search (models/hmmprofile.py, the
hmmsearch tool) against gsearch_tpu's, on the CPU.

Parsing and packing are host code: fields and arrays are equal.  The bit
scores are f32 dynamic programs whose sums run in another order than
XLA's (Forward's delete chain is a Hillis-Steele scan where JAX's
associative_scan recurses odd / even; cumsum and the exit's logsumexp
reduce in another order), so they are held within a bound relative to the
score's size, as f32 rounding grows with it:
  measured on the CPU (x86-64, `pytest -s` prints it) over the scenarios
  below, |diff| / max(|bits|, 1): Viterbi at most 3.43e-6 (largest |diff|
  5.6e-6 bits), Forward at most 3.84e-7 (largest |diff| 1.53e-5 bits, on a
  51-bit hit); bound BITS_RTOL = 1.4e-5, about 4x the larger.
E-values are computed from the scores by the same float64 host code, so
they are equal given equal scores; the TSV's rows are the same in the same
order, with bits within the bound plus 0.05 (one-decimal rounding), and
two rows whose bits lie within the bound of each other may swap."""

import math

import numpy as np
import pytest
import torch

from gsearch_tpu.cli.hmmsearch import run_hmmsearch as jax_hmmsearch
from gsearch_tpu.models.hmmprofile import HmmSearcher as JaxSearcher
from gsearch_tpu.models.hmmprofile import _pack_profiles as jax_pack
from gsearch_tpu.models.hmmprofile import parse_hmmer3 as jax_parse
from gsearch_tpu_torch.cli.main import main as torch_main
from gsearch_tpu_torch.models.hmmprofile import (HMM_ALPHABET, HmmSearcher, _log_linear_scan,
                                                 _pack_profiles, _scan_levels, parse_hmmer3)
from torch_synth import AAS, bits_bound, write_profile

CPU = torch.device("cpu")



def _mutate(rng, s, rate):
    a = np.array(list(s))
    hit = rng.random(len(a)) < rate
    a[hit] = rng.choice(AAS, int(hit.sum()))
    return "".join(a)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """5 profiles of 12-80 nodes in one padded block (two in one file), and
    sequences across three length buckets (T = 16, 64, 256): random ones,
    each profile's consensus planted at 15% mutation, unknown residues,
    one of length 1."""
    root = tmp_path_factory.mktemp("hmm")
    rng = np.random.default_rng(7)
    lengths = (12, 30, 47, 64, 80)
    cons = {}
    for i, L in enumerate(lengths):
        path = root / ("pair.hmm" if i < 2 else f"p{i}.HMM")
        cons[f"P{i}"] = write_profile(path, f"P{i}", L, rng, ga=None if i == 3 else 15.0 + i,
                                      stats=i != 4)
    seqs = ["M", "W", "".join(rng.choice(AAS, 9))]
    seqs += ["".join(rng.choice(AAS, int(n))) for n in rng.integers(33, 64, 6)]
    seqs += ["".join(rng.choice(AAS, int(n))) for n in rng.integers(129, 256, 5)]
    # planted: P0-P2 in the T = 64 bucket, P3 and P4 in the T = 256 one
    for i, (c, ln) in enumerate(zip(cons.values(), (50, 60, 64, 200, 250))):
        left = int(rng.integers(0, ln - len(c) + 1))
        seqs.append("".join(rng.choice(AAS, left)) + _mutate(rng, c, 0.15)
                    + "".join(rng.choice(AAS, ln - len(c) - left)))
    seqs.append("XBZUO" + _mutate(rng, cons["P1"], 0.1) + "*J")
    names = [f"s{i}" for i in range(len(seqs))]
    faa = root / "prot.faa"
    faa.write_text("".join(f">{n} protein {i}\n{s}\n" for i, (n, s) in enumerate(zip(names, seqs))))
    files = [root / "pair.hmm"] + [root / f"p{i}.HMM" for i in range(2, 5)]
    return {"root": root, "files": files, "seqs": seqs, "faa": faa, "lengths": lengths}


def _profiles(data, parse):
    return [p for f in data["files"] for p in parse(str(f))]


def test_parse_and_pack_equal(data):
    want, got = _profiles(data, jax_parse), _profiles(data, parse_hmmer3)
    assert [p.length for p in got] == list(data["lengths"])
    for a, b in zip(want, got):
        for field in ("name", "acc", "length", "desc", "stats_vit", "stats_fwd"):
            assert getattr(b, field) == getattr(a, field), field
        assert (b.ga == a.ga) or (math.isnan(b.ga) and math.isnan(a.ga))
        np.testing.assert_array_equal(b.match_logodds, a.match_logodds)
        np.testing.assert_array_equal(b.trans, a.trans)
        assert np.isneginf(b.trans[-1, 2]) and np.isneginf(b.trans[-1, 6])
    assert got[0].stats_fwd == (-4.2, 0.71) and math.isnan(got[3].ga) and got[4].stats_vit == ()
    for x, y in zip(_pack_profiles(got), jax_pack(want)):
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x, np.asarray(y))


def test_doubling_scan_matches_sequential_recurrence():
    """D[j] = logaddexp(b[j], a[j] + D[j-1]) with -inf coefficients and
    terms (a `*` transition, the shifted j = 0, padding) and -1e30 clamps."""
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 64, 81):
        a = torch.from_numpy(np.log(rng.uniform(0.05, 1.0, (3, 1, n))).astype(np.float32))
        b = torch.from_numpy(rng.normal(0, 3, (3, 4, n)).astype(np.float32))
        a[:, :, 0] = -math.inf
        a[1, :, n // 2:] = -math.inf
        b[2, :, n // 3:] = -math.inf
        b[0, 1, :] = -1e30
        got = _log_linear_scan(_scan_levels(a), b)
        want = b.double().clone()
        for j in range(1, n):
            want[..., j] = torch.logaddexp(b[..., j].double(), a[..., j].double() + want[..., j - 1])
        assert not torch.isnan(got).any()
        torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-5)


@pytest.fixture(scope="module")
def scores(data):
    """Bits of both packages by (algo, multihit), each computed once."""
    want_p, got_p = _profiles(data, jax_parse), _profiles(data, parse_hmmer3)
    enc = [HmmSearcher.encode(s) for s in data["seqs"]]
    out = {}

    def get(algo, multihit):
        if (algo, multihit) not in out:
            ref = JaxSearcher(want_p, multihit=multihit)
            port = HmmSearcher(got_p, device=CPU, multihit=multihit)
            out[algo, multihit] = (ref.score(enc, algo), port.score(enc, algo), ref, port)
        return out[algo, multihit]
    return get


@pytest.mark.parametrize("multihit", [True, False], ids=["multihit", "unihit"])
@pytest.mark.parametrize("algo", ["viterbi", "forward"])
def test_bits_within_bound(data, scores, algo, multihit):
    want, got, _, port = scores(algo, multihit)
    assert got.shape == (5, len(data["seqs"])) and got.dtype == np.float32
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    rel = diff / np.maximum(np.abs(want), 1.0)
    print(f"\n{algo} {'multihit' if multihit else 'unihit'}: max |diff| {diff.max():.3g} bits, "
          f"max rel {rel.max():.3g}")
    assert (diff <= bits_bound(want)).all()
    assert port.stats["blocks"] == 3  # T = 16, 64, 256
    assert port.stats["cells"] == 5 * 81 * (8 * 16 + 16 * 64 + 8 * 256)
    # each profile scores its own planted consensus highest
    planted = np.arange(len(data["seqs"]) - 6, len(data["seqs"]) - 1)
    assert (got[:, planted].argmax(1) == np.arange(5)).all()


def test_unknown_residues_and_forward_ge_viterbi(data, scores):
    enc = HmmSearcher.encode("xbzuo*J" + "w")
    assert enc.tolist() == [0, 0, 0, 0, 0, 0, 0, HMM_ALPHABET.index("W")]
    np.testing.assert_array_equal(enc, JaxSearcher.encode("xbzuo*J" + "w"))
    fwd, vit = scores("forward", True)[1], scores("viterbi", True)[1]
    assert (fwd >= vit - 1e-3).all()


@pytest.mark.parametrize("algo", ["viterbi", "forward"])
def test_evalues_equal(scores, algo):
    want_bits, got_bits, ref, port = scores(algo, True)
    for bits in (want_bits, got_bits):
        ev_w, ev_g = ref.evalues(bits, 1000, algo), port.evalues(bits, 1000, algo)
        np.testing.assert_array_equal(ev_g, ev_w)
    assert np.isnan(port.evalues(got_bits, 10, algo)[4]).all()


def _rows(path):
    lines = open(path).read().splitlines()
    assert lines[0].startswith("# seq_name")
    return [l.split("\t") for l in lines[1:]]


@pytest.mark.parametrize("cut_ga", [False, True])
def test_cli_tsv(data, tmp_path, cut_ga):
    hmm = str(data["root"])  # the directory: .hmm and .HMM files
    flags = ["--cut_ga"] if cut_ga else ["-E", "50"]
    assert jax_hmmsearch(str(data["faa"]), hmm, str(tmp_path / "j.tsv"), cut_ga=cut_ga,
                         e_max=None if cut_ga else 50.0) == 0
    assert torch_main(["hmmsearch", "-f", str(data["faa"]), "-m", hmm, "-o", str(tmp_path / "t.tsv"),
                       *flags, "--device", "cpu"]) == 0
    want, got = _rows(tmp_path / "j.tsv"), _rows(tmp_path / "t.tsv")
    assert len(got) == len(want) and len(got) > (4 if cut_ga else 20)
    by_key = {(r[0], r[1]): r for r in want}
    for i, (g, w) in enumerate(zip(got, want)):
        if g[:2] != w[:2]:  # a swap: both rows' bits within the bound of each other
            assert g[1] == w[1], (i, g, w)
            assert abs(float(g[3]) - float(w[3])) <= 2 * bits_bound(float(w[3])) + 0.1, (i, g, w)
        ref = by_key[g[0], g[1]]
        assert g[2] == ref[2] and g[6] == ref[6]
        for col in (3, 4):
            assert abs(float(g[col]) - float(ref[col])) <= bits_bound(float(ref[col])) + 0.05, (g, ref)
        if ref[5] != "nan":
            assert math.isclose(float(g[5]), float(ref[5]), rel_tol=1e-3)
    if cut_ga:  # every planted consensus with a GA line passes its cutoff, at the top
        tops = {}
        for r in got:
            tops.setdefault(r[1], r[0])
        assert {tops[p] for p in ("P0", "P1", "P2", "P4")} <= {f"s{i}" for i in range(14, 20)}
