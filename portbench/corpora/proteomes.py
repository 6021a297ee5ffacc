"""The `proteomes` corpus: predicted proteomes as gzipped protein FASTA
(`.faa.gz`), shaped like Prodigal's output, which GTDB's protein files are,
as `tohnsw --aa` reads a directory of them.

A proteome holds one protein per `bases_per_protein` bases of a genome
length; the lengths are log-spaced over `lengths` (as the `genomes` corpus
draws them), so every seed gets the same protein counts in another order.
A protein's length is drawn from a gamma distribution (`protein_shape`,
mean `protein_mean`) clipped to `protein_range`; it starts with M, its other
residues follow the UniProtKB/Swiss-Prot amino-acid composition, and it
ends in Prodigal's `*`.  A `x_share` of the proteins hold `x_count` X; a
`paralog_share` are paralogs: a copy of an earlier protein of the same
proteome with a `paralog_redraw` share of its residues (not its M) drawn
anew, so some 7-mers occur more than once.  Headers are Prodigal's, lines
LINE wide.  `bases` counts the residue letters a pass reads (M and X
included, `*` not).
"""

from __future__ import annotations

import gzip
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

DATA = "AA"
LINE = 60

_RESIDUES = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", dtype=np.uint8)
# UniProtKB/Swiss-Prot composition (%), in _RESIDUES' order
_PERCENT = np.array([8.25, 5.53, 4.06, 5.45, 1.37, 3.93, 6.75, 7.07, 2.27, 5.96,
                     9.66, 5.84, 2.42, 3.86, 4.70, 6.56, 5.34, 1.08, 2.92, 6.87])
_CDF = np.cumsum(_PERCENT / _PERCENT.sum())


def _residues(rng: np.random.Generator, n: int) -> np.ndarray:
    return _RESIDUES[np.minimum(np.searchsorted(_CDF, rng.random(n), side="right"), len(_RESIDUES) - 1)]


def _lengths(rng: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    shape = spec["protein_shape"]
    raw = rng.gamma(shape, spec["protein_mean"] / shape, n)
    return np.clip(np.round(raw), *spec["protein_range"]).astype(np.int64)


def proteome(rng: np.random.Generator, spec: dict, n: int) -> tuple:
    """(residues, lengths) of n proteins: the letters concatenated (no `*`)
    and each protein's length."""
    lengths = _lengths(rng, spec, n)
    paralog = rng.random(n) < spec["paralog_share"]
    paralog[0] = False
    source = (rng.random(n) * np.arange(n)).astype(np.int64)  # an earlier protein
    for i in np.nonzero(paralog)[0]:  # in order: a source is final before its copies
        lengths[i] = lengths[source[i]]
    starts = np.cumsum(lengths) - lengths
    seq = _residues(rng, int(lengths.sum()))
    seq[starts] = ord("M")
    for i in np.nonzero(paralog)[0]:
        a, b, length = starts[i], starts[source[i]], lengths[i]
        seq[a : a + length] = seq[b : b + length]
        share = rng.uniform(*spec["paralog_redraw"])
        pos = 1 + rng.choice(length - 1, int(round(share * (length - 1))), replace=False)
        seq[a + pos] = _residues(rng, len(pos))
    for i in np.nonzero(rng.random(n) < spec["x_share"])[0]:
        count = int(rng.integers(spec["x_count"][0], spec["x_count"][1] + 1))
        seq[starts[i] + 1 + rng.choice(lengths[i] - 1, count, replace=False)] = ord("X")
    return seq, lengths


def _faa(seq: np.ndarray, lengths: np.ndarray, name: str) -> bytes:
    """Prodigal-style records: a header, the protein and its `*` in LINE-wide
    lines."""
    letters = lengths + 1  # the `*`
    heads, end = [], 0
    for i, length in enumerate(lengths.tolist(), 1):
        begin = end + 1 + 60 * (i % 7)  # an intergenic gap, then the gene and its stop codon
        end = begin + 3 * (length + 1) - 1
        strand = 1 if i % 3 else -1
        heads.append(f">{name}_1_{i} # {begin} # {end} # {strand} # ID=1_{i};partial=00;start_type=ATG;"
                     f"rbs_motif=AGGAG;rbs_spacer=5-10bp;gc_cont=0.512\n".encode())
    head_len = np.array([len(h) for h in heads], dtype=np.int64)
    body = letters + -(-letters // LINE)  # letters and a newline ending each line
    size = head_len + body
    start = np.cumsum(size) - size
    out = np.full(int(size.sum()), ord("\n"), dtype=np.uint8)
    within = np.arange(int(head_len.sum())) - np.repeat(np.cumsum(head_len) - head_len, head_len)
    out[np.repeat(start, head_len) + within] = np.frombuffer(b"".join(heads), np.uint8)
    text = np.empty(int(letters.sum()), np.uint8)
    text_start = np.cumsum(letters) - letters
    keep = np.ones(len(text), bool)
    keep[text_start + lengths] = False
    text[keep] = seq
    text[~keep] = ord("*")
    j = np.arange(len(text)) - np.repeat(text_start, letters)
    out[np.repeat(start + head_len, letters) + j + j // LINE] = text
    return out.tobytes()


def write(root: str, spec: dict, seed: int) -> dict:
    """Write `spec["genomes"]` proteomes under root as p0000.faa.gz ...
    Returns {"files": [...], "bases": residue letters a pass reads}."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    count = spec["genomes"]
    genome = np.exp(np.linspace(*np.log(spec["lengths"]), count))[rng.permutation(count)]
    proteins = np.maximum(1, np.round(genome / spec["bases_per_protein"])).astype(np.int64)
    jobs, bases = [], 0
    for g in range(count):
        seq, lengths = proteome(rng, spec, int(proteins[g]))
        bases += len(seq)
        jobs.append((os.path.join(root, f"p{g:04d}.faa.gz"), seq, lengths, f"p{g:04d}"))

    def write_one(job):
        path, seq, lengths, name = job
        with open(path, "wb") as f:
            # mtime 0: the same seed writes the same bytes
            f.write(gzip.compress(_faa(seq, lengths, name), compresslevel=spec["gzip_level"], mtime=0))
        return path

    with ThreadPoolExecutor(max_workers=spec.get("writers", 4)) as pool:
        files = list(pool.map(write_one, jobs))
    return {"files": files, "bases": bases}
