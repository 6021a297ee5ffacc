"""gsearch_tpu_torch gene prediction against gsearch_tpu's, on the CPU.

The same seeded inputs (made with numpy) go through gsearch_tpu's
models/genepred.py and cli/genepred.py and through the port's.  Bit-equal:
the host tables and model files, the emissions and bonuses without context
tables, the transition table, the plain Viterbi decoder's paths (N runs,
all-padding windows whose states tie, indels, a start forced into NC), the
windowed decode of a short contig (the power-of-two padding) and of one
past 64 windows, and the genes and CLI files.  With context tables the
port sums the 61-tap window in a fixed order and XLA convolves: the
bonuses agree within CTX_RTOL, and the tests that run a context model say
whether that moved a path.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsearch_tpu.models.genepred as R
import gsearch_tpu_torch.models.genepred as P
from gsearch_tpu.cli import genepred as rcli
from gsearch_tpu_torch.cli import genepred as pcli
from gsearch_tpu_torch.ops import viterbi as pv
from torch_synth import gene_recall_precision, revcomp, synth_genome, write_fgs_train_dir

CPU = torch.device("cpu")
#: bonuses with context tables: |port - reference| <= CTX_RTOL * max(|ref|, 1).
#: The port adds the 61 taps in order, XLA's convolution in its own order;
#: measured at most 2.0e-5 calibrated and 4.3e-6 uncalibrated over the 36
#: seeded table sets of test_precompute_scores_with_context_within_tolerance;
#: about 2.5x the larger
CTX_RTOL = 5e-5
#: decoded paths with context tables: the share of positions where the
#: port's differ from the reference's (scores within CTX_RTOL can flip a
#: near-tie); measured 0 on test_decode_windows_with_context's windows
CTX_PATH_SHARE = 0.01


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _codes(rng, b: int, l: int, n_runs: int = 2) -> np.ndarray:
    """Coding-like rows: planted genes, with N runs and a 255 tail."""
    rows = []
    for _ in range(b):
        seq, _ = synth_genome(rng, l, n_runs=n_runs)
        rows.append(P.encode_dna(seq[:l]))
    out = np.stack(rows)
    out[:, -37:] = 255
    return out


def _model(rng, nb_bins=5):
    favored = [c for c, aa in R._CODON_AA.items() if aa != "*"]
    cds = [("ATG" + "".join(rng.choice(favored, 120)) + "TAA").encode() for _ in range(20)]
    return R.GeneModel.train_from_cds(cds, nb_bins=nb_bins)


def _tables(kind: str, rng) -> dict:
    """Keyword tables of _precompute_scores for one configuration."""
    kw = {"codon_lu": R.default_codon_logusage(), "dicodon_lu": None}
    model = _model(rng, 1)
    if kind in ("dicodon", "dicodon_rdi"):
        kw["dicodon_lu"] = model.dicodon_logusage[0]
    if kind == "dicodon_rdi":
        kw["rdicodon_lu"] = _model(rng, 1).dicodon_logusage[0]
    if kind == "nc_lm":
        p = rng.dirichlet(np.ones(4), 4)
        kw["nc_lm"] = np.log(p).astype(np.float32)
    if kind == "start_prior":
        kw["start_prior"] = rng.normal(0, 1, 64).astype(np.float32)
    return kw


@jax.jit
def _ref_scores_jit(codes, codon_lu, dicodon_lu, sb, pb, nc_lm, ctx, ctx_aff, ctx_weight, ctx_cap,
                    ctx_neg_cap, start_prior, rdicodon_lu):
    return R._precompute_scores(codes, codon_lu, dicodon_lu, sb, pb, nc_lm=nc_lm, ctx=ctx,
                                ctx_aff=ctx_aff, ctx_weight=ctx_weight, ctx_cap=ctx_cap,
                                ctx_neg_cap=ctx_neg_cap, start_prior=start_prior,
                                rdicodon_lu=rdicodon_lu)


def _ref_scores(codes, kw, sb=3.0, pb=9.0, ctx_weight=1.0, ctx_cap=8.0, ctx_neg_cap=6.0):
    """gsearch_tpu's scores, jitted with the tables as arguments (one
    compile a pattern of absent tables), the scalars as f32."""
    f32 = jnp.float32
    out = _ref_scores_jit(jnp.asarray(codes), kw["codon_lu"], kw.get("dicodon_lu"), f32(sb), f32(pb),
                          kw.get("nc_lm"), kw.get("ctx"), kw.get("ctx_aff"), f32(ctx_weight),
                          f32(ctx_cap), f32(ctx_neg_cap), kw.get("start_prior"), kw.get("rdicodon_lu"))
    return [np.asarray(x) for x in out]


def _port_scores(codes, kw, sb=3.0, pb=9.0, ctx_weight=1.0, ctx_cap=8.0, ctx_neg_cap=6.0):
    out = P._precompute_scores(torch.from_numpy(codes), kw["codon_lu"], kw.get("dicodon_lu"),
                               sb, pb, nc_lm=kw.get("nc_lm"), ctx=kw.get("ctx"),
                               ctx_aff=kw.get("ctx_aff"), ctx_weight=ctx_weight, ctx_cap=ctx_cap,
                               ctx_neg_cap=ctx_neg_cap, start_prior=kw.get("start_prior"),
                               rdicodon_lu=kw.get("rdicodon_lu"))
    return [x.numpy() for x in out]


def _genes(gs) -> list:
    return [(g.start, g.end, g.strand, g.nt, g.aa) for g in gs]


# ---- host tables and model files --------------------------------------------

def test_host_tables_equal():
    assert P._CODON_AA == R._CODON_AA and P._AA_FAMILIES == R._AA_FAMILIES
    assert [P._codon_id(c) for c in R._CODON_AA] == [R._codon_id(c) for c in R._CODON_AA]
    np.testing.assert_array_equal(P.default_codon_logusage(), R.default_codon_logusage())
    p = np.random.default_rng(1).dirichlet(np.ones(64), 3)
    np.testing.assert_array_equal(P.synonymous_smooth(p), R.synonymous_smooth(p))
    np.testing.assert_array_equal(P._floor_stops(p), R._floor_stops(p))
    assert dataclasses.asdict(P.GenePredParams()).keys() == dataclasses.asdict(R.GenePredParams()).keys()
    for mode in (False, True):
        assert P.GenePredParams(allow_indels=mode).stop_bonus == R.GenePredParams(allow_indels=mode).stop_bonus


@pytest.mark.parametrize("writer", ["gsearch_tpu", "port"])
def test_gene_model_files_load_across_packages(tmp_path, writer):
    """A GeneModel .npz written by either package loads in the other: the
    CG-binned codon / dicodon tables and a FragGeneScan directory's full
    table set (contexts, calibration, dists)."""
    rng = np.random.default_rng(7)
    tdir = tmp_path / "train"
    tdir.mkdir()
    write_fgs_train_dir(str(tdir), rng)
    src, dst = (R, P) if writer == "gsearch_tpu" else (P, R)
    for i, model in enumerate((src.GeneModel.train_from_cds(
            [b"ATG" + bytes(rng.choice(list(b"ACGT"), 300)) + b"TAA" for _ in range(12)], nb_bins=5),
            src.GeneModel.from_fgs_train_dir(str(tdir), "complete"))):
        model.save(str(tmp_path / f"m{i}.npz"))
        back = dst.GeneModel.load(str(tmp_path / f"m{i}.npz"))
        for name in ("cg_bins", "codon_logusage", *R.GeneModel._OPT):
            a, b = getattr(model, name), getattr(back, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=name)


def test_train_file_readers_equal(tmp_path):
    rng = np.random.default_rng(8)
    write_fgs_train_dir(str(tmp_path), rng)
    for name in ("cg_bins", "codon_logusage", *R.GeneModel._OPT):
        a = getattr(R.GeneModel.from_fgs_train_dir(str(tmp_path)), name)
        b = getattr(P.GeneModel.from_fgs_train_dir(str(tmp_path)), name)
        np.testing.assert_array_equal(a, b, err_msg=name)
    a = R.GeneModel.from_fgs_gene_file(str(tmp_path / "gene"))
    b = P.GeneModel.from_fgs_gene_file(str(tmp_path / "gene"))
    np.testing.assert_array_equal(a.dicodon_logusage, b.dicodon_logusage)
    assert (R.read_fgs_transitions(str(tmp_path / "complete"))
            == P.read_fgs_transitions(str(tmp_path / "complete")))
    cds = ["ATG" + "".join(rng.choice(list("ACGT"), 297)) + "TAA" for _ in range(9)]
    a, b = R.GeneModel.train_from_cds(cds), P.GeneModel.train_from_cds(cds)
    np.testing.assert_array_equal(a.dicodon_logusage, b.dicodon_logusage)
    codes = P.encode_dna(synth_genome(rng, 5000)[0].tobytes())
    assert R._ctx_score_host(codes, a.dicodon_logusage[0][:61], 500) == \
        P._ctx_score_host(codes, a.dicodon_logusage[0][:61], 500)


# ---- emissions and bonuses ---------------------------------------------------

@pytest.mark.parametrize("kind", ["prior", "dicodon", "dicodon_rdi", "nc_lm", "start_prior"])
def test_precompute_scores_bit_equal(kind):
    rng = np.random.default_rng(11)
    codes = _codes(rng, 3, 2000)
    kw = _tables(kind, rng)
    for a, b in zip(_ref_scores(codes, kw), _port_scores(codes, kw)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("calibrated", [False, True])
def test_precompute_scores_with_context_within_tolerance(tmp_path, calibrated):
    """Context tables (a FragGeneScan train directory's start / stop /
    start1 / stop1 log-odds, optionally calibrated by its pwm), 6 seeded
    directories x 3 CG bins: emissions bit-equal, bonuses within CTX_RTOL
    of the reference's."""
    worst = 0.0
    for seed in range(6):
        rng = np.random.default_rng(100 + seed)
        tdir = tmp_path / str(seed)
        tdir.mkdir()
        write_fgs_train_dir(str(tdir), rng)
        model = R.GeneModel.from_fgs_train_dir(str(tdir))
        for b, cg in enumerate(model.cg_bins):
            nc, ctx, aff = model.ctx_for(cg)
            kw = {"codon_lu": model.codon_logusage[b], "dicodon_lu": model.dicodon_logusage[b],
                  "rdicodon_lu": model.rdicodon_logusage[b], "nc_lm": nc, "ctx": ctx,
                  "ctx_aff": aff if calibrated else np.tile(np.float32([1.0, 0.0]), (4, 1))}
            codes = _codes(rng, 3, 2000)
            ref, port = _ref_scores(codes, kw), _port_scores(codes, kw)
            np.testing.assert_array_equal(_bits(ref[0]), _bits(port[0]))
            for a, c in zip(ref[1:], port[1:]):
                worst = max(worst, float((np.abs(a - c) / np.maximum(np.abs(a), 1.0)).max()))
    assert worst <= CTX_RTOL, worst


# ---- the decoder -------------------------------------------------------------

@pytest.mark.parametrize("p_start,indels", [(1 / 400, False), (1 / 400, True), (0.004, False)])
def test_transition_table_equal(p_start, indels):
    log_indel = np.log(0.01) if indels else R._NEG_BIG
    ref = jax.jit(lambda p: R._transition_table(jnp.log1p(-2.0 * p), jnp.log(p),
                                                jnp.float32(log_indel)))(jnp.float32(p_start))
    np.testing.assert_array_equal(_bits(ref), _bits(pv.transition_table(p_start, log_indel)))


_ref_viterbi = jax.jit(R._viterbi)


def _viterbi_case(case: str, rng):
    """(e, four bonuses, dp0, p_start, log_indel) for a batch of 4 windows
    of 4,096 bases."""
    b, w = 4, 4096
    log_indel = np.float32(np.log(0.01) if case == "indels" else R._NEG_BIG)
    if case == "random":
        e = rng.normal(-1.5, 2.0, (b, w, 11)).astype(np.float32)
        bon = [rng.normal(0, 4, (b, w)).astype(np.float32) for _ in range(4)]
    else:
        codes = _codes(rng, b, w)
        if case == "all_padding":
            codes[1:] = 255                     # every state ties along these rows
        if case == "indels":
            codes[:, 2000] = 255                # a frame break mid-window
        e, *bon = _ref_scores(codes, _tables("prior", rng), pb=6.0 if case == "indels" else 9.0)
    dp0 = np.zeros((b, 11), np.float32)
    if case == "nc_start":
        dp0[0] = R._NEG_BIG
        dp0[0, R.NC] = 0.0
    return e, bon, dp0, np.float32(1 / 400), log_indel


@pytest.mark.parametrize("case", ["random", "planted", "all_padding", "indels", "nc_start"])
def test_viterbi_plain_bit_equal(case):
    rng = np.random.default_rng(13)
    e, bon, dp0, p_start, log_indel = _viterbi_case(case, rng)
    ref = np.asarray(_ref_viterbi(jnp.asarray(e), *map(jnp.asarray, bon), jnp.asarray(dp0),
                                  jnp.float32(p_start), jnp.float32(log_indel))).T
    tb = torch.from_numpy(pv.transition_table(float(p_start), float(log_indel)))
    got = pv.viterbi(*(torch.tensor(x) for x in (e, *bon, dp0)), tb)
    assert got.dtype == torch.int8 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_viterbi_wrapper_checks_inputs():
    e = torch.zeros((2, 8, 11))
    bon = [torch.zeros((2, 8)) for _ in range(4)]
    tb = torch.zeros((11, 11))
    with pytest.raises(TypeError):
        pv.viterbi(e.double(), *bon, torch.zeros((2, 11)), tb)
    with pytest.raises(ValueError):
        pv.viterbi(e, *bon[:3], torch.zeros((2, 7)), torch.zeros((2, 11)), tb)


# ---- the decode of a batch of windows (_decode_windows) -----------------------

def _wrap_windows(rng, b: int = 4, w: int = 2000) -> np.ndarray:
    """Seeded windows with N runs and a 255 tail, and the reads torch.roll
    wraps planted: row 1 ends in a stop codon (a stop hit at i = 0) and
    row 2 in CAT, a reverse start (a rev-end hit and its prior at i = 0);
    row 3 opens with "TA" then N (read as TAA: a stop hit at i = 3)."""
    codes = _codes(rng, b, w)
    codes[1, -3:] = P.encode_dna(b"TAA")
    codes[2, -3:] = P.encode_dna(b"CAT")
    codes[3, :3] = [3, 0, 255]
    return codes


def _ref_decode_windows(codes, kw, dp0, log_indel, sb=3.0, pb=9.0, ctx_weight=1.0, ctx_cap=8.0,
                        ctx_neg_cap=6.0) -> np.ndarray:
    """gsearch_tpu's `_decode_windows` (one jitted program a pattern of
    absent tables), absent tables as zeros, as its `_decode_path` passes."""
    f32 = jnp.float32
    has = {k: kw.get(k) is not None for k in ("dicodon_lu", "nc_lm", "ctx", "start_prior", "rdicodon_lu")}
    z = lambda k, shape: jnp.asarray(kw[k]) if has[k] else jnp.zeros(shape, f32)
    aff = kw.get("ctx_aff")
    aff = jnp.asarray(aff) if aff is not None else jnp.tile(jnp.asarray([1.0, 0.0], f32), (4, 1))
    out = R._decode_windows(jnp.asarray(codes), jnp.asarray(kw["codon_lu"]), z("dicodon_lu", (64, 64)),
                            f32(sb), f32(pb), f32(1 / 400), f32(log_indel), jnp.asarray(dp0),
                            z("nc_lm", (4, 4)), z("ctx", (4, 61, 64)), aff, f32(ctx_weight), f32(ctx_cap),
                            f32(ctx_neg_cap), z("start_prior", (64,)), z("rdicodon_lu", (64, 64)),
                            has_di=has["dicodon_lu"], has_nc=has["nc_lm"], has_ctx=has["ctx"],
                            has_prior=has["start_prior"], has_rdi=has["dicodon_lu"] and has["rdicodon_lu"])
    return np.asarray(out)


def _port_decode_windows(codes, kw, dp0, log_indel, sb=3.0, pb=9.0, ctx_weight=1.0, ctx_cap=8.0,
                         ctx_neg_cap=6.0) -> np.ndarray:
    tb = torch.from_numpy(pv.transition_table(1 / 400, log_indel))
    return P._decode_windows(torch.from_numpy(codes), torch.from_numpy(dp0), tb, **kw,
                             start_codon_bonus=sb, stop_codon_bonus=pb, ctx_weight=ctx_weight,
                             ctx_cap=ctx_cap, ctx_neg_cap=ctx_neg_cap).numpy()


def _dp0(form: str, b: int) -> np.ndarray:
    dp0 = np.zeros((b, 11), np.float32)
    if form == "nc_first":  # a contig's first window starts in NC, the others free
        dp0[0] = R._NEG_BIG
        dp0[0, R.NC] = 0.0
    return dp0


@pytest.mark.parametrize("dp0_form", ["nc_first", "zeros"])
@pytest.mark.parametrize("kind", ["prior", "dicodon", "dicodon_rdi", "nc_lm", "start_prior", "indels"])
def test_decode_windows_bit_equal(kind, dp0_form):
    """The port's `_decode_windows` on the CPU (the plain composition the
    fused kernel is held to on the card) against gsearch_tpu's one jitted
    program, bit for bit: every table variant the CLI decodes with, both
    dp0 forms, the wrapped reads at i = 0-2 and "TA" + N."""
    rng = np.random.default_rng(40)
    codes = _wrap_windows(rng)
    kw = _tables("prior" if kind == "indels" else kind, rng)
    log_indel = np.float32(np.log(0.01)) if kind == "indels" else np.float32(R._NEG_BIG)
    dp0 = _dp0(dp0_form, len(codes))
    ref = _ref_decode_windows(codes, kw, dp0, log_indel)
    port = _port_decode_windows(codes, kw, dp0, log_indel)
    assert port.dtype == np.int8 and port.shape == codes.shape
    np.testing.assert_array_equal(port, ref)


def test_decode_windows_wrap_cases_move_bonuses():
    """The planted rows do reach the wrapped reads: their bonuses at i < 4
    differ from the same rows with the wrap cut (the codes after them
    made invalid)."""
    rng = np.random.default_rng(40)
    codes = _wrap_windows(rng)
    kw = _tables("start_prior", rng)
    cut = codes.copy()
    cut[1:3, -3:] = 255
    cut[3, 2] = 0                                # "TAA" without the N: the same stop
    a, b = _port_scores(codes, kw), _port_scores(cut, kw)
    stop, rev_end = 2, 4
    assert a[stop][1, 0] != b[stop][1, 0]        # row 1: stop hit at i = 0 from the tail
    assert a[rev_end][2, 0] != b[rev_end][2, 0]  # row 2: rev-end hit (and prior) at i = 0
    assert a[stop][3, 3] == b[stop][3, 3] == np.float32(9.0)  # "TA" + N reads as TAA


@pytest.mark.parametrize("calibrated", [False, True])
def test_decode_windows_with_context(tmp_path, calibrated):
    """With a context model the port's bonuses stay within CTX_RTOL of the
    reference's (test_precompute_scores_with_context_within_tolerance), and
    its `_decode_windows` path differs from gsearch_tpu's at no more than
    CTX_PATH_SHARE of the positions (none on this seed).  On the CPU the
    port's `_decode_windows` is its plain composition itself; the card
    test test_genepred_decode_kernel_matches_plain holds the fused kernel
    to it bit for bit."""
    rng = np.random.default_rng(41)
    write_fgs_train_dir(str(tmp_path), rng)
    model = R.GeneModel.from_fgs_train_dir(str(tmp_path))
    nc, ctx, aff = model.ctx_for(model.cg_bins[1])
    kw = {"codon_lu": model.codon_logusage[1], "dicodon_lu": model.dicodon_logusage[1],
          "rdicodon_lu": model.rdicodon_logusage[1], "nc_lm": nc, "ctx": ctx,
          "ctx_aff": aff if calibrated else np.tile(np.float32([1.0, 0.0]), (4, 1)),
          "start_prior": rng.normal(0, 1, 64).astype(np.float32)}
    codes = _wrap_windows(rng)
    ref, port = _ref_scores(codes, kw), _port_scores(codes, kw)
    np.testing.assert_array_equal(_bits(ref[0]), _bits(port[0]))
    for a, c in zip(ref[1:], port[1:]):
        assert float((np.abs(a - c) / np.maximum(np.abs(a), 1.0)).max()) <= CTX_RTOL
    dp0 = _dp0("nc_first", len(codes))
    got = _port_decode_windows(codes, kw, dp0, np.float32(R._NEG_BIG))
    want = _ref_decode_windows(codes, kw, dp0, np.float32(R._NEG_BIG))
    assert got.dtype == np.int8 and got.shape == codes.shape
    assert float((got != want).mean()) <= CTX_PATH_SHARE


def test_genepred_decode_launcher_checks_inputs():
    """The fused kernel's launcher takes CUDA tensors only (the CPU's plain
    composition is `_decode_windows`) and names an unknown table."""
    codes = torch.zeros((2, 64), dtype=torch.uint8)
    dp0, tb = torch.zeros((2, 11)), torch.zeros((11, 11))
    scal = dict(start_codon_bonus=3.0, stop_codon_bonus=9.0, ctx_weight=1.0, ctx_cap=8.0, ctx_neg_cap=6.0)
    with pytest.raises(ValueError, match="_decode_windows"):
        pv.genepred_decode(codes, dp0, tb, codon_lu=torch.zeros(64), **scal)
    with pytest.raises(TypeError, match="unknown tables"):
        pv.genepred_decode(codes, dp0, tb, codon_lu=torch.zeros(64), dicodon=torch.zeros((64, 64)), **scal)


def _decode_both(seq: bytes, params=None):
    p = params or R.GenePredParams()
    codes = P.encode_dna(seq)
    ref = R._decode_path(codes, p, p.codon_logusage, p.dicodon_logusage)
    pp = P.GenePredParams(**{f.name: getattr(p, f.name) for f in dataclasses.fields(p)})
    port = P._decode_path(codes, pp, pp.codon_logusage, pp.dicodon_logusage, device=CPU)
    return ref, port


@pytest.mark.parametrize("length", [3000, 6000, 64 * 6144 + 5000])
def test_decode_path_bit_equal(length):
    """One short contig padded to 4,096 or 8,192 bases (the padded tail is
    decoded; the backtrace starts at its end), and one past 64 windows of
    6,144-base cores, where the reference crosses its 64-window dispatch."""
    rng = np.random.default_rng(length)
    seq, _ = synth_genome(rng, length, n_runs=1)
    ref, port = _decode_both(seq[:length].tobytes())
    assert port.dtype == np.int8 and len(port) == length
    np.testing.assert_array_equal(port, ref)
    if length > 64 * 6144:
        assert len(P._windows(P.encode_dna(seq[:length].tobytes()))[0]) > P._MAX_BATCH


# ---- genes -------------------------------------------------------------------

def _genome(seed: int, length: int = 40_000) -> bytes:
    seq, _ = synth_genome(np.random.default_rng(seed), length, n_runs=1)
    return seq.tobytes()


def _frameshifted(rng) -> bytes:
    """A read with one gene whose frame an inserted base breaks."""
    seq, genes = synth_genome(rng, 6000, spacer=(300, 400))
    s, e, _ = max(genes, key=lambda g: g[1] - g[0])
    mid = (s + e) // 2
    return (seq[:mid].tobytes() + b"A" + seq[mid:].tobytes())


@pytest.mark.parametrize("case", ["prior", "dicodon_model", "cg_binned_from_gsearch_tpu",
                                  "cg_binned_from_port", "fragments", "indels"])
def test_predict_genes_identical(tmp_path, case):
    rng = np.random.default_rng(21)
    seq = _genome(21)
    kw = {}
    if case == "dicodon_model":
        # tables trained on another planted genome's genes
        other, genes = synth_genome(rng, 60_000)
        cds = [other[a:b] if st == "+" else revcomp(other[a:b]) for a, b, st in genes]
        cds = [c.tobytes() for c in cds]
        ref = R.predict_genes(seq, R.GenePredParams(model=R.GeneModel.train_from_cds(cds, nb_bins=1)))
        port = P.predict_genes(seq, P.GenePredParams(model=P.GeneModel.train_from_cds(cds, nb_bins=1)),
                               device=CPU)
        assert ref and _genes(port) == _genes(ref)
        return
    elif case.startswith("cg_binned"):
        src, dst = (R, P) if case.endswith("gsearch_tpu") else (P, R)
        favored = [c for c, aa in R._CODON_AA.items() if aa != "*"]
        model = src.GeneModel.train_from_cds(
            ["ATG" + "".join(rng.choice(favored, 150)) + "TAA" for _ in range(30)], nb_bins=5)
        model.save(str(tmp_path / "m.npz"))
        ref_model = R.GeneModel.load(str(tmp_path / "m.npz"))
        port_model = P.GeneModel.load(str(tmp_path / "m.npz"))
        ref = R.predict_genes(seq, R.GenePredParams(model=ref_model))
        port = P.predict_genes(seq, P.GenePredParams(model=port_model), device=CPU)
        assert ref and _genes(port) == _genes(ref)
        return
    elif case == "fragments":
        kw.update(whole_genes_only=False, min_gene_len=60)
        seq = seq[5000:9000]
    elif case == "indels":
        kw.update(whole_genes_only=False, allow_indels=True, indel_rate=0.01)
        seq = _frameshifted(rng)
    ref = R.predict_genes(seq, R.GenePredParams(**kw))
    port = P.predict_genes(seq, P.GenePredParams(**kw), device=CPU)
    assert ref, "the reference called no gene"
    assert _genes(port) == _genes(ref)


def test_predict_genes_with_context_model(tmp_path):
    """A FragGeneScan directory's model (context tables): the bonuses agree
    within CTX_RTOL, and on this genome no path moves: the same genes."""
    rng = np.random.default_rng(22)
    write_fgs_train_dir(str(tmp_path), rng)
    seq = _genome(22)
    ref = R.predict_genes(seq, R.GenePredParams(model=R.GeneModel.from_fgs_train_dir(str(tmp_path))))
    port = P.predict_genes(seq, P.GenePredParams(model=P.GeneModel.from_fgs_train_dir(str(tmp_path))),
                           device=CPU)
    assert _genes(port) == _genes(ref), "the context tolerance moved a path on this genome"


def test_self_trained_params_rounds_2():
    """Two self-training rounds: every table within tolerance of the
    reference's (the calls that estimate them are the same genes), and the
    same genes with the trained parameters."""
    seq = _genome(23, 60_000)
    ref = R.self_trained_params(seq, R.GenePredParams(), rounds=2)
    port = P.self_trained_params(seq, P.GenePredParams(), rounds=2, device=CPU)
    for name in ("codon_logusage", "dicodon_logusage", "noncoding_lm", "ctx", "ctx_aff",
                 "start_prior"):
        a, b = getattr(ref, name), getattr(port, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=name)
    assert ref.ctx is not None
    assert _genes(P.predict_genes(seq, port, device=CPU)) == _genes(R.predict_genes(seq, ref))


def test_planted_genes_recovered():
    """The port on its own: planted genes on both strands come back."""
    seq, truth = synth_genome(np.random.default_rng(24), 80_000)
    called = [(g.start, g.end, g.strand) for g in P.predict_genes(seq.tobytes(), device=CPU)]
    recall, precision = gene_recall_precision(called, truth)
    assert recall >= 0.85 and precision >= 0.8, (recall, precision)
    minus = revcomp(seq).tobytes()
    flipped = [(len(seq) - e, len(seq) - s, "-" if st == "+" else "+") for s, e, st in truth]
    called = [(g.start, g.end, g.strand) for g in P.predict_genes(minus, device=CPU)]
    assert gene_recall_precision(called, flipped)[0] >= 0.85


# ---- the CLI -----------------------------------------------------------------

def _fasta(path, rng) -> None:
    recs = [("contig_1 assembly", _genome(31)), ("contig_2", _genome(32, 5000)),
            ("tiny", _genome(33, 300))]
    with open(path, "wb") as f:
        for name, seq in recs:
            f.write(b">" + name.encode() + b"\n")
            for i in range(0, len(seq), 80):
                f.write(seq[i : i + 80] + b"\n")


@pytest.mark.parametrize("train", ["standard", "json", "train_dir", "self"])
def test_cli_files_identical(tmp_path, train):
    rng = np.random.default_rng(30)
    fa = tmp_path / "g.fna"
    _fasta(fa, rng)
    extra = []
    if train == "json":
        usage = {c: float(rng.uniform(0.1, 2.0)) for c in R._CODON_AA}
        (tmp_path / "usage.json").write_text(json.dumps({"codon_usage": usage}))
        extra = ["-t", str(tmp_path / "usage.json")]
    elif train == "train_dir":
        tdir = tmp_path / "train"
        tdir.mkdir()
        write_fgs_train_dir(str(tdir), rng)
        extra = ["-t", "complete", "-r", str(tdir)]
    elif train == "self":
        extra = ["-t", "self"]
    assert rcli.main(["-s", str(fa), "-o", str(tmp_path / "ref"), *extra]) == 0
    assert pcli.main(["-s", str(fa), "-o", str(tmp_path / "port"), *extra, "--device", "cpu"]) == 0
    for ext in (".faa", ".ffn", ".gff", ".out"):
        ref = (tmp_path / ("ref" + ext)).read_bytes()
        assert (tmp_path / ("port" + ext)).read_bytes() == ref, ext
    assert (tmp_path / "ref.faa").stat().st_size > 0 or train == "train_dir"


def test_cli_through_main_and_device(tmp_path):
    """`python -m gsearch_tpu_torch genepred` forwards to the tool; without
    --device cpu it asks for a card and raises where there is none."""
    from gsearch_tpu_torch.cli.main import main

    fa = tmp_path / "g.fna"
    fa.write_bytes(b">c\n" + _genome(34, 3000) + b"\n")
    assert main(["genepred", "-s", str(fa), "-o", str(tmp_path / "o"), "--device", "cpu"]) == 0
    assert (tmp_path / "o.gff").read_text().startswith("##gff-version 3\n")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            main(["genepred", "-s", str(fa), "-o", str(tmp_path / "o2")])
