"""Seeded inputs shared by the port's tests, importing no JAX (so
tests/test_torch_cuda.py and chip_smoke.py can use them on the card's
machine): HMMER3 profiles, reference-format database dumps, the bound that
holds the port's profile-HMM bit scores (measured in
tests/test_torch_hmmsearch.py), planted prokaryote genomes and
FragGeneScan train directories for gene prediction."""

import json
import math
import os
import struct

import numpy as np

from gsearch_tpu_torch.models.hmmprofile import BG_FREQ, HMM_ALPHABET

AAS = np.array(list(HMM_ALPHABET))
#: |diff| <= BITS_RTOL * max(|bits|, 1): about 4x the largest relative
#: difference measured between the port and gsearch_tpu on the CPU
BITS_RTOL = 1.4e-5


def bits_bound(ref):
    return BITS_RTOL * np.maximum(np.abs(np.asarray(ref, np.float64)), 1.0)


def _nl(p):
    return "*" if p <= 0 else f"{-math.log(p):.5f}"


def write_profile(path, name, length, rng, *, ga=20.0, stats=True, consensus=None):
    """A HMMER3/f profile: each node's match state puts 0.45-0.85 on its
    consensus residue and the rest on the background; typical transitions
    drawn per node; the last node's m->d and d->d are `*`, as HMMER writes
    them, and node 0's d->d too.  Returns the consensus string."""
    consensus = consensus or "".join(rng.choice(AAS, length))
    lines = ["HMMER3/f [3.3 | Nov 2019]", f"NAME  {name}", f"ACC   PF{len(name):05d}.1",
             f"DESC  synthetic profile {name}", f"LENG  {length}", "ALPH  amino",
             "RF    no", "CONS  yes"]
    if ga is not None:
        lines.append(f"GA    {ga:.2f} {ga:.2f};")
    if stats:
        lines += ["STATS LOCAL MSV      -9.8000  0.71000",
                  "STATS LOCAL VITERBI  -10.5000  0.71000",
                  "STATS LOCAL FORWARD  -4.2000  0.71000"]
    lines += ["HMM          " + "        ".join(HMM_ALPHABET),
              "            m->m     m->i     m->d     i->m     i->i     d->m     d->d",
              "  COMPO   " + "  ".join(_nl(f) for f in BG_FREQ),
              "          " + "  ".join(_nl(f) for f in BG_FREQ)]
    lines.append("          " + "  ".join(_nl(p) for p in (0.98, 0.01, 0.01, 0.6, 0.4, 1.0, 0.0)))
    for k, aa in enumerate(consensus, start=1):
        top = rng.uniform(0.45, 0.85)
        hit = HMM_ALPHABET.index(aa)
        em = [top if i == hit else (1 - top) * f / (1.0 - BG_FREQ[hit]) for i, f in enumerate(BG_FREQ)]
        lines.append(f"  {k:5d}   " + "  ".join(_nl(p) for p in em) + f"  {k} {aa.lower()} - - -")
        lines.append("          " + "  ".join(_nl(f) for f in BG_FREQ))
        if k < length:
            mi, md = rng.uniform(0.005, 0.05, 2)
            ii, dd = rng.uniform(0.2, 0.6), rng.uniform(0.1, 0.5)
            tr = (1 - mi - md, mi, md, 1 - ii, ii, 1 - dd, dd)
        else:
            tr = (0.99, 0.01, 0.0, 0.6, 0.4, 1.0, 0.0)
        lines.append("          " + "  ".join(_nl(p) for p in tr))
    lines.append("//")
    with open(path, "a") as f:
        f.write("\n".join(lines) + "\n")
    return consensus



def write_reference_dump(d, sigs, params, seqdict_paths=None):
    """A reference-format database dump: hnswdump.hnsw.data as [u32 magic]
    [u64 DataId][u64 length][payload] records, a graph description naming
    the scalar type, the streamed seqdict.json, and `params`
    (a gsearch_tpu_torch ProcessingParams) as parameters.json."""
    n, dim = sigs.shape
    t_name = {"float32": "f32", "uint32": "u32", "uint16": "u16", "uint64": "u64"}[sigs.dtype.name]
    with open(os.path.join(d, "hnswdump.hnsw.data"), "wb") as f:
        for i in range(n):
            f.write(struct.pack("<IQQ", 0xA67F0CAF, i, dim) + sigs[i].tobytes())
    with open(os.path.join(d, "hnswdump.hnsw.graph"), "wb") as f:
        f.write(struct.pack("<IBBBQQQ", 0x2A3B4C5D, 1, 32, 16, 64, n, dim)
                + struct.pack("<Q", 11) + b"DistHamming" + struct.pack("<Q", 3) + t_name.encode()
                + b"\x00" * 64)
    with open(os.path.join(d, "seqdict.json"), "w") as f:
        for i in range(n):
            path = seqdict_paths[i] if seqdict_paths else f"/data/g{i}.fna"
            f.write(json.dumps({"id": {"path": path, "fasta_id": f"g{i}"}, "len": 1000 + i}))
    params.dump_json(d)


# ---- gene prediction: planted genomes and FragGeneScan train directories ----

_DNA = np.frombuffer(b"ACGT", dtype=np.uint8)
#: codon id (A=0 C=1 G=2 T=3, b0 * 16 + b1 * 4 + b2) -> its three bases
_CODON_BYTES = np.array([[_DNA[c >> 4], _DNA[(c >> 2) & 3], _DNA[c & 3]] for c in range(64)],
                        dtype=np.uint8)
_COMPLEMENT = np.zeros(256, np.uint8)
_COMPLEMENT[list(b"ACGTN")] = list(b"TGCAN")
_STARTS = {"ATG": 0.90, "GTG": 0.08, "TTG": 0.02}    # E. coli start usage
_STOPS = {"TAA": 0.61, "TAG": 0.09, "TGA": 0.30}     # E. coli K-12 stop usage


def _cid(codon: str) -> int:
    return sum("ACGT".index(b) << s for b, s in zip(codon, (4, 2, 0)))


def gene_codon_usage() -> np.ndarray:
    """P(codon) of gene bodies: the E. coli K-12 table the port ships as
    its built-in prior, with in-frame stops removed."""
    from gsearch_tpu_torch.models.genepred import default_codon_logusage

    p = np.exp(default_codon_logusage().astype(np.float64))
    p[[_cid(s) for s in _STOPS]] = 0.0
    return p / p.sum()


def revcomp(seq: np.ndarray) -> np.ndarray:
    return _COMPLEMENT[seq[::-1]]


def synth_genome(rng, length: int, usage=None, spacer=(30, 250), n_runs: int = 0):
    """A prokaryote-like genome of about `length` bases: genes on both
    strands (ATG / GTG / TTG start, codon-biased body of log-normal length
    around 300 codons, TAA / TAG / TGA stop) between uniform random spacers
    of `spacer` bases, ~0.87 of the bases coding; `n_runs` stretches of
    50-500 bases then become N (the genes they touch drop from the truth).
    Returns (uint8 ASCII bases, [(start, end, strand)]) with 0-based
    half-open gene spans."""
    usage = gene_codon_usage() if usage is None else usage
    starts, stops = list(_STARTS), list(_STOPS)
    parts, genes, pos = [], [], 0
    while pos < length:
        ig = int(rng.integers(*spacer))
        parts.append(_DNA[rng.integers(0, 4, ig)])
        pos += ig
        n_codons = int(np.clip(rng.lognormal(np.log(300), 0.55), 40, 1500))
        body = rng.choice(64, size=n_codons - 2, p=usage)
        head = starts[rng.choice(3, p=list(_STARTS.values()))]
        tail = stops[rng.choice(3, p=list(_STOPS.values()))]
        gene = np.concatenate([np.frombuffer(head.encode(), np.uint8),
                               _CODON_BYTES[body].reshape(-1),
                               np.frombuffer(tail.encode(), np.uint8)])
        strand = "+" if rng.random() < 0.5 else "-"
        parts.append(gene if strand == "+" else revcomp(gene))
        genes.append((pos, pos + len(gene), strand))
        pos += len(gene)
    seq = np.concatenate(parts)
    for _ in range(n_runs):
        a = int(rng.integers(0, len(seq) - 500))
        b = a + int(rng.integers(50, 500))
        seq[a:b] = ord("N")
        genes = [g for g in genes if g[1] <= a or g[0] >= b]
    return seq, genes


def gene_recall_precision(pred, truth) -> tuple:
    """(recall, precision) of predicted genes against planted ones, each a
    (start, end, strand[, contig]) tuple: a call is right when it shares
    its 3' end, strand (and contig) with a planted gene (the standard
    gene-caller criterion; start calls are scored apart)."""
    def three_prime(g):
        start, end, strand, *contig = g
        return (end if strand == "+" else start, strand, *contig)

    want = {three_prime(g) for g in truth}
    got = {three_prime(g) for g in pred}
    tp = len(want & got)
    return tp / max(len(want), 1), tp / max(len(got), 1)


def write_fgs_train_dir(d, rng, cg_bins=(30.0, 50.0, 70.0)):
    """A FragGeneScan train directory in the original tool's layout (one
    CG-percent header line a bin, then the table rows): gene / rgene 96 x 4,
    noncoding 4 x 4, start / stop / start1 / stop1 61 x 64, pwm 4 x 6, and
    the per-error-model file `complete`."""
    def dirich(shape):
        p = rng.gamma(1.0, size=shape) + 1e-3
        return p / p.sum(axis=1, keepdims=True)

    def write(name, rows, width, gen):
        with open(os.path.join(d, name), "w") as f:
            for cg in cg_bins:
                f.write(f"{cg:g}\n")
                tab = gen()
                for r in range(rows):
                    f.write(" ".join(f"{v:.6f}" for v in tab[r][:width]) + "\n")

    write("gene", 96, 4, lambda: dirich((96, 4)))
    write("rgene", 96, 4, lambda: dirich((96, 4)))
    write("noncoding", 4, 4, lambda: dirich((4, 4)))
    for n in ("start", "stop", "start1", "stop1"):
        write(n, 61, 64, lambda: dirich((61, 64)))
    write("pwm", 4, 6, lambda: np.array([[3.0, 40.0, 0.7, 4.0, -5.0, 0.3]] * 4))
    with open(os.path.join(d, "complete"), "w") as f:
        f.write("Transition\n")
        for k, v in (("MM", 0.920), ("MI", 0.002), ("MD", 0.002), ("II", 0.45), ("IM", 0.55),
                     ("DD", 0.45), ("DM", 0.55), ("GE", 0.99), ("GG", 0.99), ("ER", 0.5),
                     ("RS", 0.5), ("ES", 0.5), ("SR", 0.5)):
            f.write(f"{k} {v}\n")
