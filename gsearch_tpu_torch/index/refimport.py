"""Import a reference-format (Rust gsearch, hnsw_rs) database directory.

Counterpart of gsearch_tpu/index/refimport.py.  The directory holds

  hnswdump.hnsw.data    hnsw_rs point dump: each point's signature, tagged
                        with its DataId (its rank in the seqdict)
  hnswdump.hnsw.graph   hnsw_rs layer dump; only its description header is
                        read (the scalar type name), the graph is rebuilt
  seqdict.json          streamed concatenated {"id":{"path","fasta_id"},
                        "len"} records, or the array form
  parameters.json       the processing parameters (the same schema)

The host readers below are the port's copies of the reference's.  The
record layout of the data file is solved, not assumed: file_size ==
header + n * (overhead + payload) over a grid of (header, overhead), and a
candidate is accepted when a u64 field of its per-record overhead runs
0..n-1 (a wrong stride cannot produce the identity sequence).  The
signatures then go into the port's index on `device` (flat below
`flat_auto_limit`, else the bulk graph build) and out through `dumpall`.

One deliberate difference: the graph description's type name replaces
parameters.json's dtype only when a record layout of that item size
validates against the data file; gsearch_tpu takes it unchecked, so a
stray type-name-like string in the header makes it read the data wrongly.
"""

from __future__ import annotations

import json
import os
import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.params import DataType, ProcessingParams, SketchAlgo
from ..core.seqdict import Id, ItemDict, SeqDict
from ..utils import StageTimer, get_logger

log = get_logger(__name__)


def reference_sig_dtype(params: ProcessingParams) -> np.dtype:
    """The reference's signature scalar for (algo, kmer_size, data_t): the
    element type stored in hnswdump.hnsw.data."""
    algo = params.sketch.algo
    k = params.sketch.kmer_size
    wide_k = 6 if params.sketch.data_t == DataType.AA else 16
    if algo in (SketchAlgo.SUPER, SketchAlgo.OPTDENS, SketchAlgo.REVOPTDENS):
        return np.dtype(np.float32)
    if algo == SketchAlgo.HLL:
        return np.dtype(np.uint16)
    # PROB3A / SUPER2 carry k-mer hashes: u32 up to wide_k, u64 beyond
    return np.dtype(np.uint64 if k > wide_k else np.uint32)


#: scalar type names an hnsw_rs graph-dump description carries
_T_NAMES = {"u16": np.uint16, "u32": np.uint32, "u64": np.uint64,
            "f32": np.float32, "f64": np.float64,
            "i32": np.int32, "i64": np.int64}


def read_reference_description(graph_path: str) -> Optional[str]:
    """The scalar type name of an hnsw_rs graph-dump description header, or
    None: a known distance name followed, within 32 bytes, by a known type
    name with a plausible length prefix (u64, u32 or one byte)."""
    try:
        with open(graph_path, "rb") as f:
            head = f.read(512)
    except OSError:
        return None
    dist_pos = -1
    for dn in (b"DistHamming", b"DistL2", b"DistL1", b"DistCosine",
               b"DistJaccard", b"DistLevenshtein"):
        p = head.find(dn)
        if p >= 0:
            dist_pos = p + len(dn)
            break
    if dist_pos < 0:
        return None
    window = head[dist_pos : dist_pos + 32]
    for name in _T_NAMES:
        nb = name.encode()
        p = window.find(nb)
        if p < 0:
            continue
        pre = window[:p]
        ln = len(nb)
        if (pre.endswith(struct.pack("<Q", ln))
                or pre.endswith(struct.pack("<I", ln))
                or pre.endswith(struct.pack("<B", ln))):
            return name
    return None


def read_reference_seqdict(path: str) -> SeqDict:
    """seqdict.json in the reference's streamed form (concatenated top-level
    objects, nested or flat) or the array form."""
    with open(path, "r") as f:
        text = f.read()
    stripped = text.lstrip()
    sd = SeqDict()
    if stripped.startswith("["):
        for d in json.loads(stripped):
            sd.push(ItemDict.from_json(d))
        return sd
    dec = json.JSONDecoder()
    pos, end = 0, len(text)
    while True:
        while pos < end and text[pos].isspace():
            pos += 1
        if pos >= end:
            break
        obj, pos = dec.raw_decode(text, pos)
        if "id" in obj:  # the reference's nested form
            sd.push(ItemDict(
                id=Id(path=obj["id"]["path"], fasta_id=obj["id"]["fasta_id"]),
                len=int(obj["len"]),
            ))
        else:
            sd.push(ItemDict.from_json(obj))
    return sd


def _candidate_layouts(file_size: int, n: int, payload: int):
    """(header, overhead) pairs in [0, 32]^2 consistent with the file size.
    A constant payload makes even varint length prefixes a fixed stride, so
    the grid covers fixed and varint framings alike."""
    for header in range(0, 33):
        for overhead in range(0, 33):
            if header + n * (overhead + payload) == file_size:
                yield header, overhead


def _validate_ids(mm: np.memmap, header: int, overhead: int, payload: int,
                  n: int) -> Optional[int]:
    """The offset within the record of a u64 field equal to the record's
    rank on every sampled record, or None."""
    if overhead < 8:
        return None
    stride = overhead + payload
    sample = np.unique(np.concatenate([
        np.arange(min(n, 64)),
        np.linspace(0, n - 1, num=min(n, 64)).astype(np.int64),
    ]))
    for id_off in range(0, overhead - 7):
        ok = True
        for r in sample:
            base = header + int(r) * stride + id_off
            got = int(np.frombuffer(mm[base : base + 8].tobytes(), "<u8")[0])
            if got != int(r):
                ok = False
                break
        if ok:
            return id_off
    return None


def _layouts(path: str, n: int, payload: int) -> List[Tuple[int, int, Optional[int]]]:
    """Every (header, overhead, id offset or None) the file decomposes into."""
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    return [(header, overhead, _validate_ids(mm, header, overhead, payload, n))
            for header, overhead in _candidate_layouts(os.path.getsize(path), n, payload)]


def ids_validate(path: str, n: int, dim: int, dtype) -> bool:
    """Whether some record layout of n records of dim `dtype` scalars holds
    rank-sequential DataIds."""
    payload = dim * np.dtype(dtype).itemsize
    return any(id_off is not None for _, _, id_off in _layouts(path, n, payload))


def read_hnsw_data(path: str, n: int, dim: int, dtype: np.dtype) -> np.ndarray:
    """Parse hnswdump.hnsw.data into a [n, dim] signature matrix."""
    dtype = np.dtype(dtype)
    payload = dim * dtype.itemsize
    choices = _layouts(path, n, payload)
    if not choices:
        raise ValueError(
            f"{path}: size {os.path.getsize(path)} does not decompose as "
            f"header + {n} * (overhead + {payload}); wrong n/dim/dtype "
            f"(n from seqdict.json, dim/dtype from parameters.json)?")
    # a layout whose DataIds validate, the smallest overhead first
    with_ids = [c for c in choices if c[2] is not None]
    if with_ids:
        header, overhead, id_off = min(with_ids, key=lambda c: c[1])
    elif len(choices) == 1 and choices[0][1] == 0:
        header, overhead, id_off = choices[0]  # a bare matrix, no record tags
    else:
        raise ValueError(
            f"{path}: no candidate record layout contains rank-sequential "
            f"DataIds (tried {choices}); refusing to guess")
    log.info("hnsw data layout: header=%d overhead=%d id_offset=%s", header, overhead, id_off)
    stride = overhead + payload
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    out = np.empty((n, dim), dtype=dtype)
    rows = mm[header : header + n * stride].reshape(n, stride)
    out[:] = rows[:, overhead:].view(dtype).reshape(n, dim)
    return out


def fold_u64_sigs(sigs: np.ndarray) -> np.ndarray:
    """u64 signatures -> u32 by xor-folding the halves: equal slots stay
    equal, unequal ones collide with probability 2^-32."""
    u = sigs.view(np.uint32).reshape(sigs.shape[0], sigs.shape[1], 2)
    return (u[:, :, 0] ^ u[:, :, 1]).astype(np.uint32)


def import_reference_db(ref_dir: str, out_dir: str, index_kind: str = "auto",
                        *, device: torch.device) -> dict:
    """Convert a reference database directory into a native one: read the
    signatures and metadata, insert them into a flat or graph index on
    `device`, dump the database to out_dir.  Returns a summary with the
    stage walls (read, build, dump) and, for a graph, its build passes."""
    from ..pipeline import _new_index
    from .serialize import dumpall

    timer = StageTimer()
    with timer.stage("read"):
        params = ProcessingParams.reload_json(ref_dir)
        seqdict = read_reference_seqdict(os.path.join(ref_dir, "seqdict.json"))
        n = len(seqdict)
        dim = params.sketch.sketch_size
        dtype = reference_sig_dtype(params)
        data_path = os.path.join(ref_dir, "hnswdump.hnsw.data")
        t_name = read_reference_description(os.path.join(ref_dir, "hnswdump.hnsw.graph"))
        if t_name is not None and np.dtype(_T_NAMES[t_name]) != dtype:
            desc_dtype = np.dtype(_T_NAMES[t_name])
            if ids_validate(data_path, n, dim, desc_dtype):
                log.warning("graph description says %s but parameters.json implies %s; "
                            "the data file validates as %s: using the description",
                            t_name, dtype.name, t_name)
                dtype = desc_dtype
            else:
                log.warning("graph description says %s but no record layout of that size "
                            "validates against the data file: keeping parameters.json's %s",
                            t_name, dtype.name)
        log.info("importing %d signatures [%d x %d %s] from %s", n, n, dim, dtype.name, data_path)
        sigs = read_hnsw_data(data_path, n, dim, dtype)
        if dtype == np.uint64:
            sigs = fold_u64_sigs(sigs)
    with timer.stage("build"):
        index = _new_index(params, sigs.dtype, index_kind, nb_hint=n, device=device)
        index.insert(sigs)
        del sigs
    with timer.stage("dump"):
        os.makedirs(out_dir, exist_ok=True)
        dumpall(out_dir, index, seqdict, params)
    log.info("imported %d points -> %s (%s index)", n, out_dir, index.KIND)
    return {"nb_points": n, "sketch_size": dim, "source_dtype": dtype.name,
            "index_kind": index.KIND, "out": out_dir,
            "stages": {k: v["wall_s"] for k, v in timer.report().items()},
            "build_passes": dict(getattr(index, "stats", {}).get("build_s", {}))}
