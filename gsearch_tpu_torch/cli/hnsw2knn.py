"""hnsw2knn: dump a database's own k-NN graph.

Counterpart of gsearch_tpu/cli/hnsw2knn.py, same output: one line a node,
"path:\\tpath:dist\\tpath:dist...", distances as {d:.5f}, for a flat, graph
or sharded database.
"""

from __future__ import annotations

import argparse
import sys

import torch


def run_hnsw2knn(db_dir: str, knbn: int, output: str, *, device: torch.device) -> int:
    from ..analysis.kgraph import kgraph_from_index
    from ..core import SeqDict
    from ..index.serialize import load_index

    index = load_index(db_dir, device)
    seqdict = SeqDict.reload_json(db_dir)
    kg = kgraph_from_index(index, knbn=knbn)
    with open(output, "w") as out:
        for i in range(kg.nb_nodes):
            parts = [f"{seqdict[i].id.path}:"]
            for j, d in zip(kg.neighbors[i], kg.distances[i]):
                parts.append(f"{seqdict[int(j)].id.path}:{d:.5f}")
            out.write("\t".join(parts) + "\n")
    return kg.nb_nodes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hnsw2knn", description="dump database k-NN graph")
    ap.add_argument("-b", "--hnsw", required=True, dest="db_dir")
    ap.add_argument("-n", "--knbn", type=int, default=10)
    ap.add_argument("-o", "--output", default="knn.txt")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    from ..utils import resolve_device

    n = run_hnsw2knn(args.db_dir, args.knbn, args.output, device=resolve_device(args.device))
    print(f"wrote {n} nodes to {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
