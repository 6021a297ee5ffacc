"""gsearch_tpu_torch command-line interface.

The subcommands and flags of gsearch_tpu's CLI for the ported slice:
tohnsw (all six sketching algorithms, DNA and `--aa`) / add / request /
ann / import / reformat, and the tools bindash / hypermash / superaai /
superani / hnsw2knn / hnswcore / bigsig / hmmsearch / genepred, forwarded to their
own parsers; plus `--device`
(default cuda; asking for cuda without a card raises, the CPU is asked
for with --device cpu), `--mesh` (pipeline.py, parallel/mesh.py) and
`--trace FILE` (tohnsw / add / request write the spans and counters of
utils/trace.py as JSON to FILE).  As in the
reference, add/request take no algorithm flags: everything is reloaded
from the database's parameters.json.
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_global(p: argparse.ArgumentParser, top: bool = False) -> None:
    """Global flags, accepted before or after the subcommand (a subparser's
    own default would overwrite the value given before it, so only the
    top-level parser carries defaults)."""
    def default(value):
        return value if top else argparse.SUPPRESS

    p.add_argument("--pio", type=int, default=default(0), help="files per parallel IO group")
    p.add_argument("--nbthreads", type=int, default=default(0), help="host parse threads")
    p.add_argument("--mesh", type=int, default=default(0),
                   help="shard sketching and search over a mesh of devices (0 off, -1 all, N the "
                        "first N; on the CPU the N members share the one device); replaces the "
                        "reference's multiple_build/multiple_search scripts")
    p.add_argument("--device", default=default("cuda"),
                   help="torch device: cuda (default; raises without a card) or cpu")
    p.add_argument("--trace", default=default(None), metavar="FILE",
                   help="tohnsw / add / request: time the program's stages and write their "
                        "spans and counters as JSON to FILE")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="gsearch_tpu_torch",
        description="genome sketch-and-search on torch devices (gsearch capabilities)",
    )
    _add_global(ap, top=True)
    sub = ap.add_subparsers(dest="command", required=True)

    t = sub.add_parser("tohnsw", help="build a database from a directory of FASTA files")
    _add_global(t)
    t.add_argument("-d", "--dir", required=True, help="directory of genome FASTA files")
    t.add_argument("-k", "--kmer", type=int, required=True)
    t.add_argument("-s", "--sketch", type=int, required=True)
    t.add_argument("-n", "--nbng", type=int, required=True, help="max neighbors (M)")
    t.add_argument("--ef", type=int, default=1600)
    t.add_argument("--scale_modify_f", type=float, default=1.0)
    t.add_argument("--algo", default="optdens",
                   help="prob | super | super2 | hll | optdens | revoptdens")
    t.add_argument("--aa", action="store_true", help="amino-acid mode")
    t.add_argument("--block", action="store_true",
                   help="sketch whole files as one block (genome mode)")
    t.add_argument("--index", default="auto", choices=["auto", "flat", "hnsw"])
    t.add_argument("-o", "--out", default=".", help="output database directory")

    a = sub.add_parser("add", help="add genomes to an existing database")
    _add_global(a)
    a.add_argument("-b", "--hnsw", required=True, dest="hnsw_dir", help="database directory")
    a.add_argument("-n", "--new", required=True, dest="new_dir", help="directory of new genomes")

    r = sub.add_parser("request", help="search query genomes against a database")
    _add_global(r)
    r.add_argument("-b", "--hnsw", required=True, dest="hnsw_dir")
    r.add_argument("-n", "--nbanswers", type=int, required=True)
    r.add_argument("-r", "--query", required=True, dest="req_dir")
    r.add_argument("-o", "--out", default=".", help="output directory")
    r.add_argument("--ef", type=int, default=0,
                   help="graph search width (0: the index's default; ignored by the flat index)")

    n = sub.add_parser("ann", help="graph stats and 2-D embedding of a database")
    _add_global(n)
    n.add_argument("-b", "--hnsw", required=True, dest="hnsw_dir")
    n.add_argument("-s", "--stats", action="store_true")
    n.add_argument("-e", "--embed", action="store_true")
    n.add_argument("--nb_grad_batch", type=int, default=15, help="gradient batches")
    n.add_argument("--scale_rho", type=float, default=0.75)
    n.add_argument("--beta", type=float, default=1.0)
    n.add_argument("--grad_step", type=float, default=3.0)
    n.add_argument("--nb_sampling_by_edge", type=int, default=10)
    n.add_argument("--knbn", type=int, default=8, help="k-NN graph width")
    n.add_argument("-o", "--out", default=".", help="output directory")

    i = sub.add_parser("import", help="convert a reference-format database")
    _add_global(i)
    i.add_argument("-b", "--refdb", required=True, dest="ref_dir",
                   help="reference database dir (hnswdump.hnsw.data + "
                        "seqdict.json + parameters.json)")
    i.add_argument("-o", "--out", required=True, help="output database dir")
    i.add_argument("--index", default="auto", choices=["auto", "flat", "hnsw"])

    f = sub.add_parser("reformat", help="neighbors file -> TSV with ANI")
    f.add_argument("kmer", type=int)
    f.add_argument("model", type=int, help="1=Poisson, 2=Binomial")
    f.add_argument("input_file")
    f.add_argument("output_file")

    # companion tools, reachable here and as python -m gsearch_tpu_torch.cli.<tool>
    for tool in TOOLS:
        sub.add_parser(tool, add_help=False)
    return ap


TOOLS = {
    "bindash": "gsearch_tpu_torch.cli.bindash",
    "hypermash": "gsearch_tpu_torch.cli.hypermash",
    "superaai": "gsearch_tpu_torch.cli.superaai",
    "superani": "gsearch_tpu_torch.cli.superani",
    "hnsw2knn": "gsearch_tpu_torch.cli.hnsw2knn",
    "hnswcore": "gsearch_tpu_torch.cli.hnswcore",
    "bigsig": "gsearch_tpu_torch.cli.bigsig",
    "hmmsearch": "gsearch_tpu_torch.cli.hmmsearch",
    "genepred": "gsearch_tpu_torch.cli.genepred",
}


# the subcommands --trace times
TRACED = ("tohnsw", "add", "request")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in TOOLS:  # forward a tool's arguments to its own parser
        import importlib

        return importlib.import_module(TOOLS[argv[0]]).main(argv[1:])
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.trace is not None and args.command not in TRACED:
        ap.error(f"--trace applies to {', '.join(TRACED)}")

    if args.command == "reformat":
        from .reformat import reformat_file

        n = reformat_file(args.input_file, args.output_file, args.kmer, args.model)
        print(f"wrote {n} rows to {args.output_file}")
        return 0

    from ..utils import resolve_device, trace

    device = resolve_device(args.device)
    if args.trace is None:
        return _run(args, device)
    trace.enable()
    try:
        rc = _run(args, device)
    finally:
        trace.disable()
    with open(args.trace, "w") as f:
        json.dump(trace.snapshot(), f, indent=1, sort_keys=True)
    return rc


def _run(args, device) -> int:
    from ..core import ComputingParams, HnswParams, ProcessingParams, SeqSketcherParams

    computing = ComputingParams(
        nb_files_par=args.pio, nb_threads=args.nbthreads, mesh_devices=args.mesh
    )

    if args.command == "tohnsw":
        from ..pipeline import build_database

        params = ProcessingParams(
            hnsw=HnswParams(
                capacity=1_500_000,
                ef=args.ef,
                max_nb_conn=min(args.nbng, 255),
                scale_modification=args.scale_modify_f,
            ),
            sketch=SeqSketcherParams(
                kmer_size=args.kmer,
                sketch_size=args.sketch,
                algo=args.algo,  # SketchAlgo.from_name: the README's names
                data_t="AA" if args.aa else "DNA",
            ),
            block_flag=args.block,
        )
        res = build_database(args.dir, args.out, params, computing,
                             index_kind=args.index, device=device)
        print(f"built database with {res['nb_points']} points in {res['elapsed_s']:.1f}s")
        return 0

    if args.command == "import":
        from ..index.refimport import import_reference_db

        res = import_reference_db(args.ref_dir, args.out, index_kind=args.index, device=device)
        print(f"imported {res['nb_points']} points "
              f"({res['source_dtype']} sigs) -> {res['out']} ({res['index_kind']})")
        return 0

    if args.command == "add":
        from ..pipeline import add_to_database

        res = add_to_database(args.hnsw_dir, args.new_dir, computing, device=device)
        print(f"database now has {res['nb_points']} points (+{res['added']})")
        return 0

    if args.command == "request":
        from ..pipeline import request_database

        res = request_database(args.hnsw_dir, args.req_dir, args.nbanswers, computing,
                               out_dir=args.out, ef_search=args.ef, device=device)
        print(f"{res['nb_requests']} requests, {res['nb_matches']} matches "
              f"-> {res['neighbors_file']}")
        return 0

    if args.command == "ann":
        from ..analysis.embed import EmbedderParams, get_graph_stats_embed

        eparams = EmbedderParams(
            nb_grad_batch=args.nb_grad_batch,
            scale_rho=args.scale_rho,
            beta=args.beta,
            grad_step=args.grad_step,
            nb_sampling_by_edge=args.nb_sampling_by_edge,
        )
        res = get_graph_stats_embed(args.hnsw_dir, ask_stats=args.stats, embed=args.embed,
                                    knbn=args.knbn, params=eparams, out_dir=args.out,
                                    device=device)
        print(res["summary"])
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
