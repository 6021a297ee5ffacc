"""The `genomes` corpus: DNA genomes as gzipped FASTA, as tohnsw reads a
GTDB or RefSeq genome directory.  An ingest traffic mix names its corpus
(`"corpus"`, this one where it names none); the module gives `DATA`, the
symbols it writes, and `write(root, spec, seed)`, which returns the files
and the sequence symbols a pass reads."""

from __future__ import annotations

import gzip
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

DATA = "DNA"

_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)
LINE = 80


def _fasta(contigs: list, name: str) -> bytes:
    """Records of LINE-wide lines; zero bytes pad the last line and are dropped."""
    parts = []
    for c, seq in enumerate(contigs):
        parts.append(f">{name}_c{c} synthetic\n".encode())
        rows = -(-len(seq) // LINE)
        padded = np.zeros(rows * LINE, np.uint8)
        padded[: len(seq)] = seq
        text = np.empty((rows, LINE + 1), np.uint8)
        text[:, :LINE] = padded.reshape(rows, LINE)
        text[:, LINE] = ord("\n")
        body = text.reshape(-1)
        parts.append(body[body != 0].tobytes())
    return b"".join(parts)


def write(root: str, spec: dict, seed: int) -> dict:
    """Write `spec["genomes"]` prokaryote-like genomes under root as
    g0000.fna.gz ...  Every seed gets the same set of sizes in another
    order: lengths log-spaced over spec["lengths"], contig counts
    log-spaced over spec["contigs"], and an `n_run_share` of the genomes
    with `n_runs` runs of N (counts spaced over the range); the bases,
    the contig cuts, the runs' places and lengths (`n_run_len`) are drawn
    from the seed.  Returns {"files": [...], "bases": total symbols}."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    g_count = spec["genomes"]
    lengths = np.exp(np.linspace(*np.log(spec["lengths"]), g_count)).astype(np.int64)
    contigs = np.exp(np.linspace(*np.log(spec["contigs"]), g_count)).round().astype(np.int64)
    with_runs = int(round(spec["n_run_share"] * g_count))
    runs = np.linspace(*spec["n_runs"], with_runs).round().astype(np.int64)
    lengths, contigs = lengths[rng.permutation(g_count)], contigs[rng.permutation(g_count)]
    run_count = np.zeros(g_count, np.int64)
    run_count[rng.permutation(g_count)[:with_runs]] = runs
    jobs = []
    for g in range(g_count):
        length = int(lengths[g])
        seq = _ASCII[rng.integers(0, 4, length, dtype=np.uint8)]
        for _ in range(int(run_count[g])):
            run = int(rng.integers(spec["n_run_len"][0], spec["n_run_len"][1] + 1))
            at = int(rng.integers(0, length - run))
            seq[at : at + run] = ord("N")
        cuts = np.unique(rng.integers(1, length, int(contigs[g]) - 1))
        jobs.append((os.path.join(root, f"g{g:04d}.fna.gz"), np.split(seq, cuts), f"g{g:04d}"))

    def write(job):
        path, contigs, name = job
        with open(path, "wb") as f:
            # mtime 0: the same seed writes the same bytes
            f.write(gzip.compress(_fasta(contigs, name), compresslevel=spec["gzip_level"], mtime=0))
        return path

    with ThreadPoolExecutor(max_workers=spec.get("writers", 4)) as pool:
        files = list(pool.map(write, jobs))
    return {"files": files, "bases": int(lengths.sum())}
