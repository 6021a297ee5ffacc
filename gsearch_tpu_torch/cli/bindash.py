"""bindash: all-pairs densified-MinHash distance.

Counterpart of gsearch_tpu/cli/bindash.py, same output: each file of the
two lists is sketched with OptDens (`-d 0`) or RevOptDens (`-d 1`), all
pairs are compared by slot equality in one K1 call (`hamming_frac`) over
the stacked signature matrices, distance 1 - (2J/(1+J))^(1/k), TSV
"Query\\tReference\\tDistance", pairs of equal basenames forced to 0.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def read_genome_list(path: str) -> list:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def run_bindash(
    query_list: str,
    reference_list: str,
    kmer_size: int = 16,
    sketch_size: int = 2048,
    densification: int = 0,
    output: str | None = None,
    *,
    device: torch.device,
) -> int:
    from ..core.params import DataType, SeqSketcherParams, SketchAlgo
    from ..io.fasta import concat_file_codes
    from ..models import make_sketcher
    from ..ops.distance import as_int32_rows, hamming_frac

    queries = read_genome_list(query_list)
    refs = read_genome_list(reference_list)
    algo = SketchAlgo.OPTDENS if densification == 0 else SketchAlgo.REVOPTDENS
    params = SeqSketcherParams(
        kmer_size=kmer_size, sketch_size=sketch_size, algo=algo, data_t=DataType.DNA
    )
    sk = make_sketcher(params, device=device)

    def sketch_all(paths):
        return np.stack([sk.sketch_codes(concat_file_codes(p)[0]) for p in paths])

    q_sigs = sketch_all(queries)
    r_sigs = sketch_all(refs)

    ham = hamming_frac(as_int32_rows(q_sigs).to(device), as_int32_rows(r_sigs).to(device))
    j = 1.0 - ham.cpu().numpy().astype(np.float64)
    dist = 1.0 - np.power(2.0 * j / (1.0 + j), 1.0 / kmer_size)

    out = open(output, "w") if output else sys.stdout
    out.write("Query\tReference\tDistance\n")
    n = 0
    for qi, q in enumerate(queries):
        qb = os.path.basename(q)
        for ri, r in enumerate(refs):
            d = 0.0 if qb == os.path.basename(r) else dist[qi, ri]
            out.write(f"{q}\t{r}\t{d:.6f}\n")
            n += 1
    if output:
        out.close()
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bindash", description="all-pairs densified MinHash ANI")
    ap.add_argument("-q", "--query_list", required=True)
    ap.add_argument("-r", "--reference_list", required=True)
    ap.add_argument("-k", "--kmer_size", type=int, default=16)
    ap.add_argument("-s", "--sketch_size", type=int, default=2048)
    ap.add_argument("-d", "--densification", type=int, default=0, choices=[0, 1])
    ap.add_argument("-t", "--threads", type=int, default=0, help="accepted for parity; unused")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    from ..utils import resolve_device

    n = run_bindash(
        args.query_list, args.reference_list, args.kmer_size, args.sketch_size,
        args.densification, args.output, device=resolve_device(args.device),
    )
    print(f"wrote {n} pairs", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
