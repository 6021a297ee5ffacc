"""hmmsearch: score protein sequences against HMMER3 profiles.

Counterpart of gsearch_tpu/cli/hmmsearch.py with the same flags and TSV:
`-f proteome.faa -m profile.hmm|dir [-o out.tsv] [--cut_ga] [-E max]`; a
directory's `.HMM` / `.H3M` files all score in one batched device pass.
Columns: seq_name, hmm_name, hmm_acc, Forward bits, Viterbi bits, E-value
(Forward's tail, or Viterbi's where no profile has a Forward calibration)
and whether the row passes the GA cutoff; a profile's rows by descending
Forward bits (a stable sort); plus `--device` (default cuda; asking for
cuda without a card raises, the CPU is asked for with --device cpu).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def _iter_hmm_files(path: str):
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if name.upper().endswith((".HMM", ".H3M")):
                yield os.path.join(path, name)
    else:
        yield path


def run_hmmsearch(faa: str, hmm: str, output: str | None = None, cut_ga: bool = False,
                  e_max: float | None = None, *, device: torch.device) -> int:
    from ..io.fasta import parse_fasta
    from ..models.hmmprofile import HmmSearcher, parse_hmmer3

    profiles = []
    for f in _iter_hmm_files(hmm):
        profiles.extend(parse_hmmer3(f))
    if not profiles:
        print(f"no HMMER3 profiles found under {hmm}", file=sys.stderr)
        return 1

    names, seqs = [], []
    for rec in parse_fasta(faa):
        names.append(rec.fasta_id)
        seqs.append(HmmSearcher.encode(rec.seq.decode(errors="replace")))
    if not seqs:
        print(f"no sequences in {faa}", file=sys.stderr)
        return 1

    searcher = HmmSearcher(profiles, device=device)
    bits = searcher.score(seqs, algo="forward")
    vbits = searcher.score(seqs, algo="viterbi")
    ev = searcher.evalues(bits, n_targets=len(seqs), algo="forward")
    if np.isnan(ev).all():  # uncalibrated profiles: Viterbi's tail
        ev = searcher.evalues(vbits, n_targets=len(seqs), algo="viterbi")

    out = open(output, "w") if output else sys.stdout
    try:
        print("# seq_name\thmm_name\thmm_acc\tbits\tvit_bits\tevalue\tga_pass", file=out)
        n_rows = 0
        for h, p in enumerate(profiles):
            order = sorted(range(len(seqs)), key=lambda i: -bits[h, i])
            for i in order:
                b = float(bits[h, i])
                vb = float(vbits[h, i])
                e = float(ev[h, i])
                gp = "-" if p.ga != p.ga else ("1" if b >= p.ga else "0")
                if cut_ga and gp != "1":
                    continue
                if e_max is not None and e == e and e > e_max:
                    continue
                print(f"{names[i]}\t{p.name}\t{p.acc}\t{b:.1f}\t{vb:.1f}\t{e:.3g}\t{gp}", file=out)
                n_rows += 1
        print(f"wrote {n_rows} rows ({len(profiles)} profiles x {len(seqs)} seqs)",
              file=sys.stderr)
    finally:
        if output:
            out.close()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("hmmsearch")
    ap.add_argument("-f", "--faa", required=True, help="protein FASTA (.faa) file")
    ap.add_argument("-m", "--hmm", required=True,
                    help="HMMER3 profile file or directory of .HMM files")
    ap.add_argument("-o", "--output", default=None, help="output TSV (default stdout)")
    ap.add_argument("--cut_ga", action="store_true",
                    help="keep only hits above each profile's GA cutoff")
    ap.add_argument("-E", type=float, default=None, dest="e_max", help="maximum E-value")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a card) or cpu")
    a = ap.parse_args(argv)
    from ..utils import resolve_device

    return run_hmmsearch(a.faa, a.hmm, a.output, a.cut_ga, a.e_max,
                         device=resolve_device(a.device))


if __name__ == "__main__":
    raise SystemExit(main())
