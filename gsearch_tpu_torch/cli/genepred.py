"""Gene-prediction CLI, the FragGeneScanRs role: the port of
gsearch_tpu/cli/genepred.py.

Reads FASTA, calls genes on every record and writes <prefix>.faa
(proteins), <prefix>.ffn (nucleotide CDS), <prefix>.gff and <prefix>.out
(coordinates), in record order, byte for byte as gsearch_tpu's tool writes
them (the GFF source column included).  The same flags (`-s -o -w
--min_len -t -r -p --indels`) plus `--device` (default cuda; asking for
cuda without a card raises, the CPU is asked for with --device cpu).  The
model is models/genepred.py; its Viterbi decode runs the hand-written
kernel of csrc/viterbi.cu on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def load_train_model(path_or_name: str, train_dir: str | None = None):
    """Load a gene model, dispatching on the file form — the role of
    FragGeneScan's train files (reference:
    binaux/src/bin/FragGeneScanRs.rs:116-119):

    "standard"    built-in E. coli-prior codon table,
    "self"        self-training (see models.genepred.self_trained_params);
                  handled by the caller, returns the bootstrap prior,
    name + -r DIR FragGeneScan train DIRECTORY: full table set
                  (gene/rgene/noncoding/start/stop/start1/stop1/pwm),
                  `name` selects the per-error-model file as the
                  reference tool's -t does,
    *.npz         GeneModel (CG-binned tables; GeneModel.save),
    *.json        {"codon_usage": {"ATG": freq, ...}},
    anything else FragGeneScan-format `gene` train file.

    Returns (codon_logusage | None, GeneModel | None)."""
    from ..models.genepred import GeneModel, _codon_id, default_codon_logusage

    if train_dir is not None and path_or_name == "standard":
        # -r DIR with -t left at its default: the directory IS the model;
        # "complete" is the reference tool's standard per-error-model file
        return None, GeneModel.from_fgs_train_dir(train_dir)
    if path_or_name in ("standard", "self"):
        if train_dir is not None:
            print(f"warning: -r {train_dir} ignored with -t {path_or_name}",
                  file=sys.stderr)
        return default_codon_logusage(), None
    if train_dir is not None:
        return None, GeneModel.from_fgs_train_dir(train_dir, path_or_name)
    if os.path.isdir(path_or_name):
        return None, GeneModel.from_fgs_train_dir(path_or_name)
    if path_or_name.endswith(".npz"):
        return None, GeneModel.load(path_or_name)
    if path_or_name.endswith(".json"):
        with open(path_or_name) as f:
            d = json.load(f)
        usage = np.full(64, 1e-9, dtype=np.float64)
        for codon, freq in d["codon_usage"].items():
            usage[_codon_id(codon.upper())] = max(float(freq), 1e-9)
        usage /= usage.sum()
        return np.log(usage).astype(np.float32), None
    return None, GeneModel.from_fgs_gene_file(path_or_name)


def run_genepred(seq_file: str, out_prefix: str, whole_genes: bool = True,
                 min_len: int = 90, train: str = "standard",
                 indel_rate: float = 0.0, train_dir: str | None = None, *,
                 device: torch.device) -> int:
    """Call genes on every record of `seq_file`, decoding on `device`, and
    write the four files; returns the number of genes."""
    from ..io.fasta import parse_fasta
    from ..models.genepred import (GenePredParams, default_codon_logusage,
                                   predict_genes, self_trained_params)

    codon_lu, model = load_train_model(train, train_dir)
    params = GenePredParams(
        codon_logusage=codon_lu if codon_lu is not None else default_codon_logusage(),
        model=model,
        whole_genes_only=whole_genes,
        min_gene_len=min_len,
        allow_indels=indel_rate > 0,
        indel_rate=max(indel_rate, 1e-9),
    )
    if train == "self":
        # self-train on the longest contig (the richest call set), then
        # predict every record with the adapted tables
        recs = list(parse_fasta(seq_file))
        if recs:
            longest = max(recs, key=lambda r: len(r.seq))
            params = self_trained_params(longest.seq, params, device=device)
    n_genes = 0
    with open(out_prefix + ".faa", "w") as faa, \
         open(out_prefix + ".ffn", "w") as ffn, \
         open(out_prefix + ".gff", "w") as gff, \
         open(out_prefix + ".out", "w") as out:
        gff.write("##gff-version 3\n")
        for rec in parse_fasta(seq_file):
            genes = predict_genes(rec.seq, params, device=device)
            out.write(f">{rec.fasta_id}\n")
            for g in genes:
                n_genes += 1
                gid = f"{rec.fasta_id}_{g.start + 1}_{g.end}_{g.strand}"
                faa.write(f">{gid}\n{g.aa}\n")
                ffn.write(f">{gid}\n{g.nt}\n")
                # the source column names the package whose files these
                # match byte for byte
                gff.write(
                    f"{rec.fasta_id}\tgsearch_tpu\tCDS\t{g.start + 1}\t{g.end}\t.\t"
                    f"{g.strand}\t0\tID={gid}\n"
                )
                out.write(f"{g.start + 1}\t{g.end}\t{g.strand}\t1\n")
    return n_genes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="genepred",
                                 description="prokaryotic gene prediction (FragGeneScan role)")
    ap.add_argument("-s", "--seq", required=True, help="input FASTA")
    ap.add_argument("-o", "--out", required=True, help="output prefix")
    ap.add_argument("-w", "--whole", type=int, default=1,
                    help="1: whole genes (genomes), 0: allow fragments (reads)")
    ap.add_argument("--min_len", type=int, default=90)
    ap.add_argument("-t", "--train", default="standard",
                    help='"standard", "self" (organism-adaptive self-'
                         'training), a FragGeneScan train-file name (with '
                         '-r), a train directory, a GeneModel .npz, or a '
                         'JSON codon-usage file '
                         '{"codon_usage": {"ATG": freq, ...}}')
    ap.add_argument("-r", "--train-dir", default=None, dest="train_dir",
                    help="FragGeneScan train-file directory (the reference "
                         "tool's -r); -t names the per-error-model file "
                         "inside it, e.g. complete / 454_10 / illumina_5")
    ap.add_argument("-p", "--threads", type=int, default=0, help="accepted for parity; unused")
    ap.add_argument("--indels", type=float, default=0.0, metavar="RATE",
                    help="per-base indel rate of the sequencing-error model "
                         "(0 = off; the FGS 454_10 train analog is 0.01). "
                         "Decoded insertions are dropped from the CDS and "
                         "deletions restored as N, as the reference tool does")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    from ..utils import resolve_device

    device = resolve_device(args.device)
    n = run_genepred(args.seq, args.out, whole_genes=args.whole == 1,
                     min_len=args.min_len, train=args.train,
                     indel_rate=args.indels, train_dir=args.train_dir, device=device)
    print(f"predicted {n} genes -> {args.out}.faa/.ffn/.gff/.out", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
