"""k-NN graph of a database and its statistics.

Counterpart of gsearch_tpu/analysis/kgraph.py: the graph is one batched
self-search of the database (batches of 4,096 queries), with the self
column removed by a vectorised stable sort.  On CUDA, at 4,096 rows or
more and within the reference's 13e9-byte representation ceiling, the
search is the sign-expansion searcher (ops/mxu.py: int8 product, K2
rerank), where the reference takes it on a TPU; elsewhere it is the
index's own `search` (flat: K1; graph: the beam; sharded: every shard and
the host merge), as the reference's CPU path.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..ops.mxu import MxuSearcher, planned_footprint
from ..utils import get_logger

log = get_logger(__name__)

#: the reference's device ceiling for the searcher's representations
_SEARCHER_MAX_BYTES = 13_000_000_000


@dataclasses.dataclass
class KGraph:
    neighbors: np.ndarray  # int32 [N, K]
    distances: np.ndarray  # f32 [N, K]

    @property
    def nb_nodes(self) -> int:
        return self.neighbors.shape[0]

    @property
    def knbn(self) -> int:
        return self.neighbors.shape[1]

    def get_out_edges_by_idx(self, i: int):
        return list(zip(self.neighbors[i], self.distances[i]))

    def stats(self) -> dict:
        """Quantile statistics on first-neighbour distances."""
        d1 = self.distances[:, 0]
        qs = [0.05, 0.25, 0.5, 0.75, 0.95, 0.99]
        return {
            "nb_nodes": self.nb_nodes,
            "knbn": self.knbn,
            "first_dist_quantiles": {str(q): float(np.quantile(d1, q)) for q in qs},
            "mean_first_dist": float(d1.mean()),
            "max_dist": float(self.distances.max()),
        }


class Hubness:
    """In-degree (hubness) statistics of the k-NN digraph."""

    def __init__(self, kgraph: KGraph):
        self.kgraph = kgraph
        self.in_degree = np.bincount(
            kgraph.neighbors.ravel(), minlength=kgraph.nb_nodes
        ).astype(np.float64)

    def get_standard3m(self) -> float:
        """Standardised third moment (skewness) of the in-degree
        distribution."""
        d = self.in_degree
        mu = d.mean()
        sd = d.std()
        if sd == 0:
            return 0.0
        return float(((d - mu) ** 3).mean() / sd**3)

    def get_hubness_histogram(self, nb_bins: int = 20) -> np.ndarray:
        hist, _ = np.histogram(self.in_degree, bins=nb_bins)
        return hist


def _exact_searcher(sigs: np.ndarray, device: torch.device):
    """The sign-expansion searcher over the whole database on CUDA from
    4,096 rows while its representations fit the ceiling; None (the caller
    takes index.search) elsewhere."""
    if device.type != "cuda":
        return None
    n, s = sigs.shape
    if n < 4096:
        return None
    _, rep_bytes = planned_footprint(n, s)
    if rep_bytes > _SEARCHER_MAX_BYTES:
        return None
    searcher = MxuSearcher(sigs, device)
    return lambda q, k: searcher.search(q.astype(sigs.dtype), k)


def kgraph_from_index(index, knbn: int = 8, ef_search: int = 0,
                      batch: int = 4096) -> KGraph:
    """Self-search the database: the k-NN graph over its own points."""
    sigs = index.get_sigs()
    n = sigs.shape[0]
    ef = ef_search or max(64, 2 * (knbn + 1))
    out_ids = np.empty((n, knbn), dtype=np.int32)
    out_d = np.empty((n, knbn), dtype=np.float32)
    t0 = time.perf_counter()
    search = _exact_searcher(sigs, index.device) or (
        lambda q, k: index.search(q, knbn=k, ef_search=ef))
    t_init = time.perf_counter() - t0
    t_first = t_steady = 0.0
    for s in range(0, n, batch):
        e = min(n, s + batch)
        t0 = time.perf_counter()
        d, ids = search(sigs[s:e], knbn + 1)
        if s == 0:
            t_first = time.perf_counter() - t0
        else:
            t_steady += time.perf_counter() - t0
        ids = ids.astype(np.int32)
        # drop the self column: non-self first (stable, so the distance
        # order holds), then the first knbn; a row whose k+1 answers all
        # differ from itself loses its last
        not_self = ids != np.arange(s, e, dtype=np.int32)[:, None]
        keep = np.argsort(~not_self, axis=1, kind="stable")[:, :knbn]
        out_ids[s:e] = np.take_along_axis(ids, keep, axis=1)
        out_d[s:e] = np.take_along_axis(d, keep, axis=1)
    log.info("kgraph %d nodes: searcher init %.1fs, first batch %.1fs, remaining %d batches "
             "%.1fs", n, t_init, t_first, max((n - 1) // batch, 0), t_steady)
    return KGraph(neighbors=out_ids, distances=out_d)
