"""hnswcore: coreset extraction and clustering of a database.

Counterpart of gsearch_tpu/cli/hnswcore.py, same flags and files: sampled
distance quantiles, a coreset (`coreset.csv`), optionally its clustering
(`clustercoreset.csv`), and the JSON summary on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def run_hnswcore(db_dir: str, nb_coreset: int, nb_cluster: int, out_dir: str,
                 metric: str = "hamming", *, device: torch.device) -> dict:
    from ..analysis.coreset import (build_coreset, cluster_coreset, distance_quantiles,
                                    dump_cluster_csv, dump_coreset_csv, metric_rows)
    from ..core import SeqDict
    from ..index.serialize import load_index

    index = load_index(db_dir, device)
    seqdict = SeqDict.reload_json(db_dir)
    rows = metric_rows(index.get_sigs(), metric, device)  # one upload for every sweep
    del index
    q = distance_quantiles(rows, metric=metric, device=device)
    print(f"sampled distance quantiles: {json.dumps(q)}", file=sys.stderr)

    core = build_coreset(rows, nb_coreset, metric=metric, device=device)
    dump_coreset_csv(core, seqdict, os.path.join(out_dir, "coreset.csv"))
    out = {"quantiles": q, "coreset_size": len(core.ids), "coreset_cost": core.cost}
    if nb_cluster > 0:
        clus = cluster_coreset(rows, core, nb_cluster, metric=metric, device=device)
        dump_cluster_csv(clus, seqdict, os.path.join(out_dir, "clustercoreset.csv"))
        out["nb_cluster"] = len(clus.ids)
        out["cluster_cost"] = clus.cost
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hnswcore",
                                 description="coreset clustering of a sketch database")
    ap.add_argument("-b", "--hnsw", required=True, dest="db_dir")
    ap.add_argument("--coreset", type=int, default=256, help="coreset size")
    ap.add_argument("--cluster", type=int, default=0, help="clusters (0 = coreset only)")
    ap.add_argument("-o", "--out", default=".", help="output directory")
    ap.add_argument("--metric", default="hamming", choices=["hamming", "l1", "l2", "cosine"],
                    help="distance for sampling and assignment")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    from ..utils import resolve_device

    res = run_hnswcore(args.db_dir, args.coreset, args.cluster, args.out, metric=args.metric,
                       device=resolve_device(args.device))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
