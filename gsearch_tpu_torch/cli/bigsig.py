"""bigsig: build a BIGSI index over genomes and classify reads against it.

Counterpart of gsearch_tpu/cli/bigsig.py with the same flags, defaults and
outputs: `construct` writes `<prefix>.bigsi.npz` + `.bigsi.json`;
`identify` streams one (single-end) or two (paired-end: both mates' counts
summed before scoring) FASTA / FASTQ files and writes `<prefix>_reads.txt`
(one row a reported hit) and `<prefix>_counts.txt` (reads a genome by top
hit); plus `--device` (default cuda; asking for cuda without a card
raises, the CPU is asked for with --device cpu).
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter

import numpy as np
import torch


def cmd_construct(args, device: torch.device) -> int:
    from ..index.bigsi import BigsiIndex
    from ..io.fasta import concat_file_codes
    from ..io.walk import walk_fasta_dir

    idx = BigsiIndex(bloom_len=args.bloom, nb_hashes=args.hashes, kmer_size=args.kmer,
                     minimizer_window=args.minimizer, device=device)
    paths = walk_fasta_dir(args.refs)
    if not paths:
        print(f"no FASTA under {args.refs}", file=sys.stderr)
        return 1
    for p in paths:
        codes, _, total = concat_file_codes(p)
        if total == 0:
            continue
        idx.insert_genome(p, codes)
        print(f"inserted {p} ({total} bases)", file=sys.stderr)
    idx.save(args.bigsi)
    print(f"saved index over {idx.nb_genomes} genomes to {args.bigsi}.bigsi.npz")
    return 0


def cmd_identify(args, device: torch.device) -> int:
    from ..index.bigsi import BigsiIndex
    from ..io.codec import encode_dna
    from ..io.fasta import parse_reads

    idx = BigsiIndex.load(args.bigsi, device=device)
    read_len = args.read_len
    paired = len(args.reads) == 2
    names, buf, buf2 = [], [], []
    summary = Counter()
    frac_sum = Counter()
    nb_reads = 0
    out_path = args.output + "_reads.txt"

    def to_codes(seq: bytes) -> np.ndarray:
        codes = encode_dna(seq)
        if len(codes) < read_len:
            codes = np.pad(codes, (0, read_len - len(codes)), constant_values=255)
        return codes[:read_len]

    def flush(out):
        nonlocal nb_reads
        if not buf:
            return
        counts, totals = idx.raw_counts(np.stack(buf), down_sample=args.down_sample)
        if buf2:
            c2, t2 = idx.raw_counts(np.stack(buf2), down_sample=args.down_sample)
            counts, totals = counts + c2, totals + t2
        scored = idx.score_counts(counts, totals, min_fraction=args.min_fraction,
                                  fp_exponent=args.fp_correct)
        for rid, hits in zip(names, scored):
            nb_reads += 1
            if hits:
                for name, h, t, frac in hits[: args.max_hits]:
                    out.write(f"{rid}\t{name}\t{h}\t{t}\t{frac:.4f}\n")
                summary[hits[0][0]] += 1
                frac_sum[hits[0][0]] += hits[0][3]
            else:
                summary["<unclassified>"] += 1
        names.clear()
        buf.clear()
        buf2.clear()

    streams = [parse_reads(p, quality_min=args.quality) for p in args.reads]
    with open(out_path, "w") as out:
        out.write("read_id\tgenome\thits\ttotal_kmers\tcorrected_fraction\n")
        pairs = zip(*streams) if paired else ((r,) for r in streams[0])
        for recs in pairs:
            buf.append(to_codes(recs[0].seq))
            if paired:
                buf2.append(to_codes(recs[1].seq))
            names.append(recs[0].fasta_id)
            if len(buf) >= args.batch:
                flush(out)
        flush(out)

    counts_path = args.output + "_counts.txt"
    with open(counts_path, "w") as cf:
        cf.write("genome\treads\tpct_of_reads\tavg_top_fraction\tkind\n")
        for name, c in summary.most_common():
            kind = "unclassified" if name == "<unclassified>" else "genome"
            avg = frac_sum[name] / c if c and name in frac_sum else 0.0
            cf.write(f"{name}\t{c}\t{100.0 * c / max(nb_reads, 1):.2f}\t{avg:.4f}\t{kind}\n")
    mode = "paired-end" if paired else "single-end"
    print(f"classified {nb_reads} {mode} reads -> {out_path}, {counts_path}")
    for name, c in summary.most_common(10):
        print(f"  {name}: {c}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bigsig", description="BIGSI build & read classification")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("construct")
    c.add_argument("-r", "--refs", required=True, help="directory of reference FASTA")
    c.add_argument("-b", "--bigsi", required=True, help="output index prefix")
    c.add_argument("--bloom", type=int, default=25_000_000,
                   help="bloom filter length; use >= ~4x the largest genome's "
                        "distinct k-mer count to keep fill (and FP correction) low")
    c.add_argument("--hashes", type=int, default=2, help="hash functions")
    c.add_argument("-k", "--kmer", type=int, default=21)
    c.add_argument("-m", "--minimizer", type=int, default=0, help="minimizer window (0=off)")

    i = sub.add_parser("identify")
    i.add_argument("-b", "--bigsi", required=True, help="index prefix")
    i.add_argument("-q", "--reads", required=True, nargs="+",
                   help="reads FASTA/FASTQ(.gz/.xz/.bz2/.zst); two files = paired-end")
    i.add_argument("-o", "--output", default="bigsig",
                   help="output prefix -> <prefix>_reads.txt + <prefix>_counts.txt")
    i.add_argument("--read_len", type=int, default=256)
    i.add_argument("--batch", type=int, default=4096)
    i.add_argument("--min_fraction", type=float, default=0.7)
    i.add_argument("--max_hits", type=int, default=5)
    i.add_argument("-d", "--down_sample", type=int, default=1, help="probe every Nth k-mer")
    i.add_argument("-c", "--fp_correct", type=float, default=0.0,
                   help="also require binomial P(hits|FP) < 10^-VALUE (0 = off)")
    i.add_argument("-Q", "--quality", type=int, default=15,
                   help="mask FASTQ bases with phred < VALUE")
    for p in (c, i):
        p.add_argument("--device", default="cuda",
                       help="torch device: cuda (default; raises without a card) or cpu")

    args = ap.parse_args(argv)
    from ..utils import resolve_device

    device = resolve_device(args.device)
    return cmd_construct(args, device) if args.cmd == "construct" else cmd_identify(args, device)


if __name__ == "__main__":
    raise SystemExit(main())
