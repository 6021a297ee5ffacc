"""hypermash: all-pairs HyperMinHash distance.

Counterpart of gsearch_tpu/cli/hypermash.py, same output: one HyperMinHash
sketch per file over canonical k-mers, all-pairs similarity, distance
1 - (2s/(1+s))^(1/k), TSV "Query\\tReference\\tDistance", pairs of equal
basenames 0.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def run_hypermash(
    query_file: str,
    ref_file: str,
    kmer: int = 16,
    nb_buckets: int = 4096,
    output: str = "hypermash.out",
    *,
    device: torch.device,
) -> int:
    from ..io.fasta import concat_file_codes
    from ..models.hyperminhash import make_hyperminhash, similarity
    from .bindash import read_genome_list

    queries = read_genome_list(query_file)
    refs = read_genome_list(ref_file)
    sk = make_hyperminhash(nb_buckets=nb_buckets, kmer_size=kmer, device=device)

    def sketch_all(paths):
        return {p: sk.sketch_codes(concat_file_codes(p)[0]) for p in paths}

    q_sk = sketch_all(queries)
    r_sk = sketch_all(refs)

    with open(output, "w") as out:
        out.write("Query\tReference\tDistance\n")
        n = 0
        for q in queries:
            qb = os.path.basename(q)
            for r in refs:
                if qb == os.path.basename(r):
                    d = 0.0
                else:
                    s = similarity(q_sk[q], r_sk[r])
                    d = 1.0 - (2.0 * s / (1.0 + s)) ** (1.0 / kmer) if s > 0 else 1.0
                out.write(f"{q}\t{r}\t{d:.6f}\n")
                n += 1
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hypermash", description="all-pairs HyperMinHash ANI")
    ap.add_argument("-q", "--query_file", required=True)
    ap.add_argument("-r", "--ref_file", required=True)
    ap.add_argument("-k", "--kmer", type=int, default=16)
    ap.add_argument("-b", "--buckets", type=int, default=4096)
    ap.add_argument("-t", "--threads", type=int, default=0, help="accepted for parity; unused")
    ap.add_argument("-o", "--output", default="hypermash.out")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    from ..utils import resolve_device

    n = run_hypermash(args.query_file, args.ref_file, args.kmer, args.buckets, args.output,
                      device=resolve_device(args.device))
    print(f"wrote {n} pairs to {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
