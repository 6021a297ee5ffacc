"""Sharded graph index: D HnswIndex shards searched as one.

Counterpart of gsearch_tpu/index/sharded.py (the `hnsw_sharded` kind that
`gsearch_tpu tohnsw --index hnsw --mesh N` writes):

* rows are assigned round-robin to D shards: global id g lives in shard
  g % D at local row g // D, so an incremental `add` keeps every shard
  balanced (|size_i - size_j| <= 1);
* each shard is the port's HnswIndex and picks its own build and search
  route from its own size;
* `search` runs the shards one after another and merges on the host as
  the reference does: the shards' lists concatenated in shard order and a
  stable argsort on distance alone.  A distance tie between shards is
  therefore broken by shard order, not by id, unlike the port's standing
  (distance, id) order of one index.

This class searches the shards one after another on one device; a
request with a mesh of n_shards members searches each shard on its own
member instead (parallel/mesh.py `MeshGraphSearcher`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .hnsw import HnswIndex


class ShardedHnswIndex:
    KIND = "hnsw_sharded"

    def __init__(
        self,
        sketch_size: int,
        sig_dtype,
        n_shards: int,
        max_nb_conn: int = 64,
        ef_construction: int = 200,
        scale_modification: float = 1.0,
        search_prefix: int = 1024,
        *,
        device: torch.device,
    ):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.sketch_size = sketch_size
        self.sig_dtype = np.dtype(sig_dtype)
        self.n_shards = int(n_shards)
        self.max_nb_conn = int(max_nb_conn)
        self.ef_construction = int(ef_construction)
        self.scale_modification = float(scale_modification)
        self.search_prefix = min(search_prefix, sketch_size)
        self.device = device
        self.shards = [
            HnswIndex(
                sketch_size=sketch_size,
                sig_dtype=sig_dtype,
                max_nb_conn=max_nb_conn,
                ef_construction=ef_construction,
                scale_modification=scale_modification,
                search_prefix=search_prefix,
                device=device,
            )
            for _ in range(self.n_shards)
        ]

    # ------------------------------------------------------------------ basics

    @property
    def nb_points(self) -> int:
        return sum(s.nb_points for s in self.shards)

    def get_sigs(self) -> np.ndarray:
        """Signatures reassembled in global id order."""
        out = np.empty((self.nb_points, self.sketch_size), self.sig_dtype)
        for i, sh in enumerate(self.shards):
            out[i :: self.n_shards] = sh.get_sigs()
        return out

    # ------------------------------------------------------------------ build

    def insert(self, sigs: np.ndarray, batch_size: int = 1024) -> None:
        """Append a batch; global ids continue from nb_points and spread
        round-robin over the shards."""
        sigs = np.ascontiguousarray(sigs, dtype=self.sig_dtype)
        if sigs.shape[0] == 0:
            return
        first = (-self.nb_points) % self.n_shards  # row of sigs that goes to shard 0
        for i in range(self.n_shards):
            part = sigs[(first + i) % self.n_shards :: self.n_shards]
            if part.shape[0]:
                self.shards[i].insert(part, batch_size=batch_size)

    # ------------------------------------------------------------------ search

    def search(self, queries: np.ndarray, knbn: int, ef_search: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Each shard in turn, then the reference's host merge (stable on
        distance alone: ties go to the lower shard)."""
        nq = queries.shape[0]
        if self.nb_points == 0:
            return np.full((nq, 0), np.inf, np.float32), np.zeros((nq, 0), np.int32)
        knbn = min(knbn, self.nb_points)
        all_d, all_g = [], []
        for i, sh in enumerate(self.shards):
            if sh.nb_points == 0:
                continue
            d, lids = sh.search(queries, min(knbn, sh.nb_points), ef_search)
            all_d.append(d)
            all_g.append(lids.astype(np.int64) * self.n_shards + i)
        d = np.concatenate(all_d, axis=1)
        gids = np.concatenate(all_g, axis=1)
        sel = np.argsort(d, axis=1, kind="stable")[:, :knbn]
        return (np.take_along_axis(d, sel, axis=1),
                np.take_along_axis(gids, sel, axis=1).astype(np.int32))

    # ------------------------------------------------------------------ io

    def save_arrays(self, prefix: str) -> dict:
        for i, sh in enumerate(self.shards):
            sh.save_arrays(f"{prefix}.shard{i}")
        return {
            "n_shards": self.n_shards,
            "max_nb_conn": self.max_nb_conn,
            "ef_construction": self.ef_construction,
            "scale_modification": self.scale_modification,
            "search_prefix": self.search_prefix,
        }

    def _adopt(self, shards: list) -> "ShardedHnswIndex":
        self.shards = shards
        return self

    @classmethod
    def load_arrays(cls, prefix: str, meta: dict, device: torch.device) -> "ShardedHnswIndex":
        n_shards = int(meta["n_shards"])
        shards = [HnswIndex.load_arrays(f"{prefix}.shard{i}", meta, device)
                  for i in range(n_shards)]
        return cls(
            sketch_size=shards[0].sketch_size,
            sig_dtype=shards[0].sig_dtype,
            n_shards=n_shards,
            max_nb_conn=int(meta.get("max_nb_conn", 64)),
            ef_construction=int(meta.get("ef_construction", 200)),
            scale_modification=float(meta.get("scale_modification", 1.0)),
            search_prefix=int(meta.get("search_prefix", 1024)),
            device=device,
        )._adopt(shards)

    @classmethod
    def from_jax(cls, jax_index, *, device: torch.device) -> "ShardedHnswIndex":
        """Carry a gsearch_tpu ShardedHnswIndex across onto `device`, shard
        by shard through HnswIndex.from_jax."""
        return cls(
            sketch_size=jax_index.sketch_size,
            sig_dtype=jax_index.sig_dtype,
            n_shards=jax_index.n_shards,
            max_nb_conn=jax_index.max_nb_conn,
            ef_construction=jax_index.ef_construction,
            scale_modification=jax_index.scale_modification,
            search_prefix=jax_index.search_prefix,
            device=device,
        )._adopt([HnswIndex.from_jax(sh, device=device) for sh in jax_index.shards])
