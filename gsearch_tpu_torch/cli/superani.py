"""superani: all-pairs seed-chaining ANI.

Counterpart of gsearch_tpu/cli/superani.py, same output: file lists,
defaults c = 30, k = 16, TSV "Query_File\\tRef_file\\tANI\\t
Align_fraction_query\\tAlign_fraction_reference"; pairs of equal basenames
are 100 / 1 / 1.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def run_superani(query_list: str, ref_list: str, kmer: int = 16, c: int = 30,
                 output: str = "superani.out", model: str | None = None,
                 *, device: torch.device) -> int:
    from ..io.fasta import concat_file_codes
    from ..models.seedchain import AniRegression, SeedChainer
    from .bindash import read_genome_list

    queries = read_genome_list(query_list)
    refs = read_genome_list(ref_list)
    chainer = SeedChainer(k=kmer, c=c, regression=AniRegression.load(model), device=device)

    def sketch_all(paths):
        return {p: chainer.sketch(concat_file_codes(p)[0]) for p in paths}

    q_sk = sketch_all(queries)
    r_sk = sketch_all(refs)

    n = 0
    with open(output, "w") as out:
        out.write("Query_File\tRef_file\tANI\tAlign_fraction_query\tAlign_fraction_reference\n")
        for q in queries:
            qb = os.path.basename(q)
            for r in refs:
                if qb == os.path.basename(r):
                    ani, afq, afr = 100.0, 1.0, 1.0
                else:
                    ani, afq, afr = chainer.compare(q_sk[q], r_sk[r])
                out.write(f"{q}\t{r}\t{ani:.4f}\t{afq:.4f}\t{afr:.4f}\n")
                n += 1
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="superani", description="all-pairs seed-chaining ANI")
    ap.add_argument("-q", "--query_list", required=True)
    ap.add_argument("-r", "--reference_list", required=True)
    ap.add_argument("-k", "--kmer", type=int, default=16)
    ap.add_argument("-c", "--spacing", type=int, default=30)
    ap.add_argument("-t", "--threads", type=int, default=0, help="accepted for parity; unused")
    ap.add_argument("-o", "--output", default="superani.out")
    ap.add_argument("--model", default=None,
                    help="JSON regression-correction coefficients; default: the bundled "
                         "fitted model; 'none': the raw chained seed-identity ANI")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    from ..utils import resolve_device

    n = run_superani(args.query_list, args.reference_list, args.kmer, args.spacing,
                     args.output, model=args.model, device=resolve_device(args.device))
    print(f"wrote {n} pairs to {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
