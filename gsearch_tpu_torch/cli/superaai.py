"""superaai: all-pairs AAI via FracMinHash on proteomes.

Counterpart of gsearch_tpu/cli/superaai.py, same output: protein k-mers
(default k = 7), FracMinHash (scaled, optional num), similarity -> AAI via
1 + ln(2s/(1+s))/k, TSV "Query\\tReference\\tAAI".
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import torch


def run_superaai(
    query_file: str,
    ref_file: str,
    kmer: int = 7,
    scaled: int = 200,
    num: int | None = None,
    output: str = "superaai.out",
    *,
    device: torch.device,
) -> int:
    from ..core.params import DataType, SeqSketcherParams, SketchAlgo
    from ..io.fasta import concat_file_codes
    from ..models.fracminhash import FracMinHashSketcher, similarity
    from .bindash import read_genome_list

    queries = read_genome_list(query_file)
    refs = read_genome_list(ref_file)
    params = SeqSketcherParams(
        kmer_size=kmer, sketch_size=1024, algo=SketchAlgo.OPTDENS, data_t=DataType.AA
    )
    sk = FracMinHashSketcher(params, scaled=scaled, num=num, device=device)

    def sketch_all(paths):
        return {p: sk.sketch_codes(concat_file_codes(p, is_aa=True)[0]) for p in paths}

    q_sk = sketch_all(queries)
    r_sk = sketch_all(refs)

    with open(output, "w") as out:
        out.write("Query\tReference\tAAI\n")
        n = 0
        for q in queries:
            qb = os.path.basename(q)
            for r in refs:
                if qb == os.path.basename(r):
                    aai = 100.0
                else:
                    s = similarity(q_sk[q], r_sk[r])
                    aai = (1.0 + math.log(2.0 * s / (1.0 + s)) / kmer) * 100.0 if s > 0 else 0.0
                out.write(f"{q}\t{r}\t{aai:.4f}\n")
                n += 1
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="superaai", description="all-pairs AAI via FracMinHash")
    ap.add_argument("-q", "--query_file", required=True)
    ap.add_argument("-r", "--ref_file", required=True)
    ap.add_argument("-k", "--kmer", type=int, default=7)
    ap.add_argument("-s", "--scaled", type=int, default=200)
    ap.add_argument("--num", type=int, default=None)
    ap.add_argument("-t", "--threads", type=int, default=0, help="accepted for parity; unused")
    ap.add_argument("-o", "--output", default="superaai.out")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    from ..utils import resolve_device

    n = run_superaai(args.query_file, args.ref_file, args.kmer, args.scaled, args.num, args.output,
                     device=resolve_device(args.device))
    print(f"wrote {n} pairs to {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
