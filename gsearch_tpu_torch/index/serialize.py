"""Index persistence, in the reference's five-file database layout.

Counterpart of gsearch_tpu/index/serialize.py; the files are the same, so
a database written by either package is requested by the other:
    parameters.json, seqdict.json, processing_state.json  (core/)
    index.meta.json    {kind, sig_dtype, nb_points, sketch_size, sig_file}
    index.sigs.npy     signature matrix [N, S]
    index.graph.npz    (hnsw only) nbrs, nbr_d, entry_ids, pinned
    index.shard{i}.sigs.npy, index.shard{i}.graph.npz  (hnsw_sharded, a shard each)
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .flat import FlatIndex
from .hnsw import HnswIndex
from .sharded import ShardedHnswIndex

INDEX_META_FILE = "index.meta.json"
INDEX_PREFIX = "index"


def dump_index(index, dirpath: str) -> None:
    extra = index.save_arrays(os.path.join(dirpath, INDEX_PREFIX))
    meta = {
        "kind": index.KIND,
        "sig_dtype": np.dtype(index.sig_dtype).name,
        "nb_points": index.nb_points,
        "sketch_size": index.sketch_size,
    }
    meta.update(extra or {})
    with open(os.path.join(dirpath, INDEX_META_FILE), "w") as f:
        json.dump(meta, f)


def get_index_kind(dirpath: str) -> dict:
    with open(os.path.join(dirpath, INDEX_META_FILE)) as f:
        return json.load(f)


def load_index(dirpath: str, device: torch.device):
    meta = get_index_kind(dirpath)
    kinds = {cls.KIND: cls for cls in (FlatIndex, HnswIndex, ShardedHnswIndex)}
    if meta["kind"] not in kinds:
        raise ValueError(f"{dirpath}: unknown index kind {meta['kind']!r}")
    return kinds[meta["kind"]].load_arrays(os.path.join(dirpath, INDEX_PREFIX), meta, device)


def from_jax_database(dirpath: str, *, device: torch.device):
    """Load a database written by gsearch_tpu into the port's FlatIndex,
    HnswIndex or ShardedHnswIndex on `device` (no default: the caller names the card or the CPU)."""
    return load_index(dirpath, device)


def dumpall(dirpath: str, index, seqdict, params, state=None) -> None:
    """One-stop database dump."""
    os.makedirs(dirpath, exist_ok=True)
    dump_index(index, dirpath)
    seqdict.dump(dirpath)
    params.dump_json(dirpath)
    if state is not None:
        state.dump_json(dirpath)
