"""Orchestration pipelines: build (tohnsw), add, and request.

Counterpart of gsearch_tpu/pipeline.py: host ingest (walk + parse on a
producer thread, parallel parse workers; DNA files, or protein files in
amino-acid mode) -> device sketching by any of the six algorithms -> flat
or graph index -> dump, and the request path that reloads a database,
sketches the queries and writes gsearch.neighbors.txt.  `add` converts a
flat database that grows past `flat_auto_limit` to the graph index, as the
reference does.

With a mesh (`--mesh N`, `ComputingParams.mesh_devices`, or the `mesh=`
keyword, which places members on devices as the caller lists them;
parallel/mesh.py): sketching is data-parallel over the members; a graph
build writes the sharded kind with one shard a member (a 1-member mesh
writes a plain graph); a request searches a sharded graph with
`MeshGraphSearcher` (a shard/member mismatch is logged and the shards are
searched one after another, the reference's fallback), and any other
database row-sharded, by `MeshMxuSearcher` on CUDA at MXU_MIN_POINTS rows
or more (where the reference takes it on a TPU), else by `MeshSearcher`.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import List

import numpy as np
import torch

from .core import ComputingParams, Id, ItemDict, ProcessingParams, ProcessingState, SeqDict
from .index.flat import FlatIndex
from .index.hnsw import HnswIndex
from .index.sharded import ShardedHnswIndex
from .index.serialize import dumpall, get_index_kind, load_index
from .io.fasta import concat_file_codes_packed, file_records_codes, read_file_bytes
from .io.walk import bounded_thread_map, iter_file_buffers, walk_fasta_dir
from .models import make_sketcher
from .results import Matcher, Neighbour, ReqAnswer
from .utils import StageTimer, get_logger, trace

log = get_logger(__name__)

OUT_THRESHOLD = 0.99  # answer filter (reference: dnarequest.rs:83, matcher.rs:235)
EF_SEARCH = 0
NEIGHBORS_FILE = "gsearch.neighbors.txt"
MATCHES_FILE = "gsearch.matches"

# the reference's flat/graph boundary, kept identical so both packages
# pick the same index kind for a database (250,000 genomes at s=12000)
FLAT_AUTO_CAP = 262_144
FLAT_AUTO_BYTES = 12_000_000_000


def flat_auto_limit(sketch_size: int) -> int:
    return min(FLAT_AUTO_CAP, FLAT_AUTO_BYTES // max(4 * sketch_size, 1))


def _mesh_for(computing: ComputingParams, mesh, device: torch.device):
    """The mesh a call shards over: the caller's, else one of
    `computing.mesh_devices` members on `device`'s kind (0: none; -1: all)."""
    if mesh is not None or not computing.mesh_devices:
        return mesh
    from .parallel.mesh import make_device_mesh

    return make_device_mesh(computing.mesh_devices, device=device)


def _mesh_size(mesh) -> int:
    """Shards a graph build writes: one a mesh member (0 without a mesh)."""
    return 0 if mesh is None else mesh.size


def _iter_parsed(paths, is_aa: bool, block_flag: bool, computing: ComputingParams,
                 timer: StageTimer):
    """Yield (path, [(codes, fasta_id, length), ...]) per file, in path order;
    nb_threads > 1 parses files concurrently."""

    def parse_one(args):
        path, data = args
        with timer.stage("parse"):
            if data is None:
                data = read_file_bytes(path)
            if block_flag:
                # DNA block mode parses into PackedCodes (fused native parser)
                codes, first_id, total = concat_file_codes_packed(
                    path, is_aa=is_aa, data=data)
                units = [(codes, first_id, total)] if total > 0 else []
            else:
                units = [
                    (codes, fid, len(codes))
                    for codes, fid in file_records_codes(path, is_aa=is_aa, data=data)
                ]
        return path, units

    nb_threads = computing.nb_threads
    if nb_threads == 0:
        nb_threads = max(1, min(8, os.cpu_count() or 1))
    if nb_threads > 1:
        yield from bounded_thread_map(parse_one, ((p, None) for p in paths), nb_threads)
    else:
        for _rank, path, data in iter_file_buffers(paths, computing.nb_files_par):
            yield parse_one((path, data))


def _sketch_dir(
    dirpath: str,
    params: ProcessingParams,
    computing: ComputingParams,
    seqdict: SeqDict,
    timer: StageTimer,
    device: torch.device,
    mesh=None,
) -> List[np.ndarray]:
    """Walk + parse + sketch every FASTA under dirpath; extends seqdict and
    returns one signature per dictionary entry, in rank order.  A producer
    thread parses into a bounded queue while this thread submits device
    batches, which run asynchronously on CUDA; with a mesh, each batch's
    rows are split over its members."""
    is_aa = params.sketch.data_t.value == "AA"
    sketcher = make_sketcher(params.sketch, device=device)
    if mesh is not None:
        sketcher.set_mesh(mesh)
        log.info("sketching sharded over %d members", len(mesh.devices))
    paths = walk_fasta_dir(dirpath, is_aa=is_aa)
    if not paths:
        raise FileNotFoundError(f"no FASTA files under {dirpath}")
    log.info("found %d files under %s", len(paths), dirpath)
    tickets: List = []
    nb_seq = 0
    t_report = time.time()
    buf_codes: List = []
    buf_bases = 0

    def flush():
        nonlocal buf_codes, buf_bases
        if not buf_codes:
            return
        with timer.stage("sketch"):
            tickets.append(sketcher.sketch_submit(buf_codes))
        trace.count("ingest.bases", buf_bases)
        buf_codes = []
        buf_bases = 0

    q: "queue.Queue" = queue.Queue(maxsize=max(computing.nb_files_par, 8))
    _END = object()

    def produce():
        try:
            for item in _iter_parsed(paths, is_aa, params.block_flag, computing, timer):
                q.put(item)
        except BaseException as e:  # surfaced on the consumer side
            q.put(e)
        q.put(_END)

    prod = threading.Thread(target=produce, daemon=True, name="gsearch-producer")
    prod.start()
    filerank = 0
    while True:
        with trace.span("ingest.queue_wait"):
            item = q.get()
        if item is _END:
            break
        if isinstance(item, BaseException):
            raise item
        path, units = item
        filerank += 1
        for codes, fasta_id, length in units:
            if length < params.sketch.kmer_size:
                log.warning("skipping %s (%s): shorter than k", path, fasta_id)
                continue
            buf_codes.append(codes)
            buf_bases += len(codes)
            seqdict.push(ItemDict(id=Id(path=path, fasta_id=fasta_id), len=length))
            nb_seq += 1
            if buf_bases >= (1 << 26) or len(buf_codes) >= 2048:
                flush()
        if time.time() - t_report > 30:
            log.info("processed %d/%d files, %d sequences", filerank, len(paths), nb_seq)
            t_report = time.time()
    prod.join()
    flush()
    sigs: List[np.ndarray] = []
    with timer.stage("sketch-drain"):
        for t in tickets:
            sigs.extend(sketcher.sketch_finish(t))
    return sigs


def _new_index(params: ProcessingParams, sig_dtype, kind: str, nb_hint: int,
               device: torch.device, n_shards: int = 0):
    """A flat or graph index; a graph index with n_shards > 1 is the
    sharded kind, as a `--mesh N` build of gsearch_tpu writes it."""
    if kind == "auto":
        kind = "flat" if nb_hint <= flat_auto_limit(params.sketch.sketch_size) else "hnsw"
    if kind == "flat":
        return FlatIndex(params.sketch.sketch_size, sig_dtype, device)
    if kind != "hnsw":
        raise ValueError(f"unknown index kind {kind!r}")
    hkw = dict(
        sketch_size=params.sketch.sketch_size,
        sig_dtype=sig_dtype,
        max_nb_conn=params.hnsw.max_nb_conn,
        ef_construction=params.hnsw.ef,
        scale_modification=params.hnsw.scale_modification,
        device=device,
    )
    if n_shards > 1:
        return ShardedHnswIndex(n_shards=n_shards, **hkw)
    return HnswIndex(**hkw)


def build_database(genome_dir: str, out_dir: str, params: ProcessingParams,
                   computing: ComputingParams | None = None, index_kind: str = "auto",
                   *, device: torch.device, mesh=None) -> dict:
    """tohnsw: sketch a directory tree, build + dump a database.  `mesh`
    (default: made from computing.mesh_devices) shards the sketching, and
    a graph build over it writes one shard a member."""
    computing = computing or ComputingParams()
    mesh = _mesh_for(computing, mesh, device)
    timer = StageTimer()
    t0 = time.time()
    os.makedirs(out_dir, exist_ok=True)
    seqdict = SeqDict()
    sigs = _sketch_dir(genome_dir, params, computing, seqdict, timer, device, mesh)
    sig_mat = np.stack(sigs)
    index = _new_index(params, sig_mat.dtype, index_kind, len(sigs), device,
                       n_shards=_mesh_size(mesh))
    with timer.stage("index_insert"):
        index.insert(sig_mat)
    if index.nb_points != len(seqdict):
        raise ValueError(f"index holds {index.nb_points} points after the insert, seqdict "
                         f"{len(seqdict)}")
    state = ProcessingState(
        nb_seq=len(seqdict),
        nb_file=len({i.id.path for i in seqdict}),
        elapsed_t=time.time() - t0,
    )
    with timer.stage("dump"):
        dumpall(out_dir, index, seqdict, params, state)
    report = timer.report()
    log.info("build done: %d points in %.1fs %s", index.nb_points, time.time() - t0, report)
    return {"nb_points": index.nb_points, "elapsed_s": time.time() - t0, "stages": report}


def _migrate_flat_if_needed(index, params: ProcessingParams, n_after: int,
                            device: torch.device):
    """`add` growth guard: a flat database pushed past the flat auto-limit
    is converted to the graph index (a build over the existing signatures)
    before the new points go in, as gsearch_tpu does."""
    if not isinstance(index, FlatIndex):
        return index
    if n_after <= flat_auto_limit(params.sketch.sketch_size):
        return index
    log.info(
        "flat database would grow to %d points (> auto-limit %d at s=%d): "
        "converting to hnsw before the add",
        n_after, flat_auto_limit(params.sketch.sketch_size), params.sketch.sketch_size)
    new = _new_index(params, index.sig_dtype, "hnsw", n_after, device)
    new.insert(index.get_sigs())
    return new


def add_to_database(db_dir: str, new_dir: str, computing: ComputingParams | None = None,
                    *, device: torch.device, mesh=None) -> dict:
    """add: incremental insertion, parameters reloaded from the database;
    `mesh` (default: made from computing.mesh_devices) shards the
    sketching."""
    computing = computing or ComputingParams()
    mesh = _mesh_for(computing, mesh, device)
    params = ProcessingParams.reload_json(db_dir)
    seqdict = SeqDict.reload_json(db_dir)
    state = ProcessingState.reload_json(db_dir)
    index = load_index(db_dir, device)
    if index.nb_points != len(seqdict):
        raise ValueError(f"{db_dir}: index holds {index.nb_points} points, seqdict {len(seqdict)}")
    timer = StageTimer()
    t0 = time.time()
    sigs = _sketch_dir(new_dir, params, computing, seqdict, timer, device, mesh)
    index = _migrate_flat_if_needed(index, params, len(seqdict), device)
    with timer.stage("index_insert"):
        index.insert(np.stack(sigs))
    state.nb_seq = len(seqdict)
    state.nb_file = len({i.id.path for i in seqdict})
    state.elapsed_t += time.time() - t0
    dumpall(db_dir, index, seqdict, params, state)
    log.info("add done: now %d points (+%d)", index.nb_points, len(sigs))
    return {"nb_points": index.nb_points, "added": len(sigs)}


def database_sketcher(db_dir: str, *, device: torch.device):
    """The sketcher of the database at db_dir (its k, s and algorithm)."""
    return make_sketcher(ProcessingParams.reload_json(db_dir).sketch, device=device)


def read_genomes(genome_dir: str, is_aa: bool = False) -> list:
    """Each FASTA file under genome_dir (DNA, or protein with is_aa) as one
    genome (its records concatenated, block mode's unit), in walk order."""
    return [concat_file_codes_packed(p, is_aa=is_aa)[0]
            for p in walk_fasta_dir(genome_dir, is_aa=is_aa)]


def empty_index_like(db_dir: str, kind: str, *, device: torch.device, n_shards: int = 0):
    """An empty index of `kind` ("flat" or "hnsw"; "hnsw" with n_shards > 1
    the sharded graph index) with the parameters and signature type of the
    database at db_dir."""
    params = ProcessingParams.reload_json(db_dir)
    sig_dtype = np.dtype(get_index_kind(db_dir)["sig_dtype"])
    return _new_index(params, sig_dtype, kind, 0, device, n_shards=n_shards)


def dump_with_placeholders(src_dir: str, out_dir: str, index) -> None:
    """Dump `index` as a database whose first points are the genomes of the
    database at src_dir (whose parameters it keeps) and whose further
    points are placeholder genomes `decoys/d{i}.fna` with no sequence file
    behind them: signatures synthesised to grow a database to a size."""
    params = ProcessingParams.reload_json(src_dir)
    seqdict = SeqDict.reload_json(src_dir)
    state = ProcessingState.reload_json(src_dir)
    if index.nb_points < len(seqdict):
        raise ValueError(f"index holds {index.nb_points} points, fewer than {src_dir}'s "
                         f"{len(seqdict)} genomes")
    for i in range(index.nb_points - len(seqdict)):
        seqdict.push(ItemDict(id=Id(path=f"decoys/d{i}.fna", fasta_id=f"d{i}"), len=0))
    state.nb_seq = len(seqdict)
    dumpall(out_dir, index, seqdict, params, state)


def _search(index, queries: np.ndarray, knbn: int, ef_search: int, mesh):
    """The request's k-NN: the index's own search without a mesh, else the
    reference's three mesh branches."""
    if mesh is None:
        return index.search(queries, knbn=knbn, ef_search=ef_search)
    from .parallel.mesh import MeshGraphSearcher, MeshMxuSearcher, MeshSearcher

    if isinstance(index, ShardedHnswIndex):
        try:
            searcher = MeshGraphSearcher(index, mesh)
        except ValueError as e:  # shard/member mismatch
            log.warning("mesh graph search unavailable (%s); searching shards sequentially", e)
            return index.search(queries, knbn=knbn, ef_search=ef_search)
        return searcher.search(queries, knbn=knbn, ef_search=ef_search)
    sigs = index.get_sigs()
    if mesh.devices[0].type == "cuda" and sigs.shape[0] >= FlatIndex.MXU_MIN_POINTS:
        return MeshMxuSearcher(sigs, mesh).search(queries, knbn=knbn)
    return MeshSearcher(sigs, mesh).search(queries, knbn=knbn)


def request_database(db_dir: str, req_dir: str, nb_answers: int,
                     computing: ComputingParams | None = None, out_dir: str = ".",
                     ef_search: int = EF_SEARCH, *, device: torch.device, mesh=None) -> dict:
    """request: batched k-NN of query genomes against a reloaded database;
    `mesh` (default: made from computing.mesh_devices) shards the
    sketching and the search (module docstring)."""
    computing = computing or ComputingParams()
    mesh = _mesh_for(computing, mesh, device)
    params = ProcessingParams.reload_json(db_dir)
    seqdict = SeqDict.reload_json(db_dir)
    index = load_index(db_dir, device)
    timer = StageTimer()
    req_dict = SeqDict()
    sigs = _sketch_dir(req_dir, params, computing, req_dict, timer, device, mesh)
    with timer.stage("search"):
        dists, ids = _search(index, np.stack(sigs), nb_answers, ef_search, mesh)

    matcher = Matcher(threshold=OUT_THRESHOLD)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, NEIGHBORS_FILE)
    nb_match = 0
    with open(out_path, "w") as out:
        out.write(f" query dir : {req_dir}")
        for rank, item in enumerate(req_dict):
            nbrs = [Neighbour(int(i), float(d)) for d, i in zip(dists[rank], ids[rank])]
            ans = ReqAnswer(rank=rank, req_item=item, neighbours=nbrs)
            nb_match += ans.dump(seqdict, OUT_THRESHOLD, out)
            if not params.block_flag:
                for n in nbrs:
                    if n.distance < OUT_THRESHOLD:
                        matcher.insert_sequence_match(item, seqdict[n.d_id], n.distance)
    if not params.block_flag:
        with open(os.path.join(out_dir, MATCHES_FILE), "w") as out:
            matcher.analyze(out)
    log.info("request done: %d requests, %d matches -> %s", len(req_dict), nb_match, out_path)
    return {
        "nb_requests": len(req_dict),
        "nb_matches": nb_match,
        "neighbors_file": out_path,
        "stages": timer.report(),
    }
