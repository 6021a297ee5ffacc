"""UMAP-like 2-D embedding of a sketch database: the `ann` subcommand.

Counterpart of gsearch_tpu/analysis/embed.py.  The host parts (edge
weights, the diffusion-map init, landmark assignment, the coarse landmark
graph, the quality estimate) are the reference's numpy, unchanged.  The
layout is `_optimize`: a loop of full-batch steps on the device, each
pulling every k-NN edge's ends together and pushing every edge's source
away from fresh uniform negatives, then a step at a linearly decaying rate.

The scatter-adds of the reference (`.at[].add`) are sums over edges:
  - by source: the edges are `repeat(arange(n), k)`, so the sum over a
    node's edges is a sum over a contiguous group of k (`view(n, k, d)`);
  - by destination: the edges are sorted by destination once, and each
    step sums them per node with `torch.segment_reduce` (a segment a
    thread, in a fixed order: deterministic on the card, unlike the atomics
    of `index_add_`).
Negatives are drawn with `torch.randint` from a `torch.Generator` seeded
by `rng_seed` (the reference draws them under JAX's threefry, so the two
trajectories agree only in distribution); `_optimize` also takes the
draws as a tensor, which is how the parity test feeds it the reference's.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..utils import get_logger
from .kgraph import Hubness, KGraph, kgraph_from_index

log = get_logger(__name__)


@dataclasses.dataclass
class EmbedderParams:
    nb_grad_batch: int = 15
    scale_rho: float = 0.75
    beta: float = 1.0
    grad_step: float = 3.0
    nb_sampling_by_edge: int = 10
    dmap_init: bool = True
    dim: int = 2
    #: full-batch steps per reference "grad batch"
    epochs_per_batch: int = 20
    #: hierarchical init above this many points
    hier_threshold: int = 30_000
    #: landmark count for hierarchical init; 0 = auto (~n/32, in [1k, 16k])
    n_landmarks: int = 0


class Embedder:
    def __init__(self, kgraph: KGraph, params: EmbedderParams | None = None, seed: int = 0,
                 *, device: torch.device):
        self.kgraph = kgraph
        self.params = params or EmbedderParams()
        self.seed = seed
        self.device = device
        self._embedded: np.ndarray | None = None
        #: wall seconds of the last embed(): init and optimisation apart
        self.times: dict = {}

    # -- affinity weights (UMAP-style local scaling) --------------------------

    def _edge_weights(self) -> np.ndarray:
        d = self.kgraph.distances.astype(np.float64)
        rho = d.min(axis=1, keepdims=True)
        scale = np.maximum((d - rho).mean(axis=1, keepdims=True) * self.params.scale_rho, 1e-9)
        w = np.exp(-np.maximum(d - rho, 0.0) / scale)
        return w.astype(np.float32)

    def _dmap_init(self, w: np.ndarray, nbrs: np.ndarray) -> np.ndarray:
        """Diffusion-map-flavoured init: power iterations of the normalised
        affinity, orthogonalised, as starting coordinates (small-N path)."""
        n = nbrs.shape[0]
        rng = np.random.default_rng(self.seed)
        y = rng.normal(size=(n, self.params.dim)).astype(np.float32)
        deg = np.maximum(w.sum(axis=1), 1e-9)
        for _ in range(12):
            # y <- D^-1 (W y) over the sparse k-NN edges
            msg = (w[:, :, None] * y[nbrs]).sum(axis=1)
            y = msg / deg[:, None]
            y = y - y.mean(axis=0, keepdims=True)
            # orthogonalise to stop collapse onto the lead eigenvector
            qy, _ = np.linalg.qr(y)
            y = qy.astype(np.float32)
        return (y / max(np.abs(y).max(), 1e-9) * 10.0).astype(np.float32)

    # -- hierarchical init ----------------------------------------------------

    def _assign_landmarks(self, nbrs: np.ndarray, dist: np.ndarray,
                          marks: np.ndarray) -> np.ndarray:
        """Graph-nearest landmark per point: multi-source Bellman-Ford over
        the k-NN edges."""
        n, k = nbrs.shape
        dl = np.full(n, np.inf, np.float32)
        lab = np.full(n, -1, np.int64)
        dl[marks] = 0.0
        lab[marks] = np.arange(len(marks))
        d32 = np.maximum(dist.astype(np.float32), 1e-7)
        for _ in range(30):
            cand = dl[nbrs] + d32            # [n, k]
            j = np.argmin(cand, axis=1)
            best = cand[np.arange(n), j]
            take = best < dl
            if not take.any():
                break
            dl = np.where(take, best, dl)
            lab = np.where(take, lab[nbrs[np.arange(n), j]], lab)
        # disconnected leftovers: round-robin over landmarks
        miss = lab < 0
        if miss.any():
            lab[miss] = np.arange(int(miss.sum())) % len(marks)
        return lab

    def _coarse_graph(self, nbrs, w, lab, m, kc=16):
        """Inter-cluster edge weights aggregated into a fixed-shape
        (neighbours, weights) pair over the m landmarks."""
        n, k = nbrs.shape
        li = np.repeat(lab, k)
        lj = lab[nbrs.ravel()]
        ww = w.ravel().astype(np.float64)
        keep = li != lj
        li, lj, ww = li[keep], lj[keep], ww[keep]
        key = li * m + lj
        uk, inv = np.unique(key, return_inverse=True)
        agg = np.zeros(len(uk))
        np.add.at(agg, inv, ww)
        ci, cj = uk // m, uk % m
        cn = np.zeros((m, kc), np.int32)
        cw = np.zeros((m, kc), np.float32)
        order = np.lexsort((-agg, ci))
        ci_o, cj_o, agg_o = ci[order], cj[order], agg[order]
        starts = np.searchsorted(ci_o, np.arange(m + 1))
        for a in range(m):
            s, e = starts[a], min(starts[a + 1], starts[a] + kc)
            cnt = e - s
            cn[a, :cnt] = cj_o[s:e]
            cw[a, :cnt] = agg_o[s:e]
            if cnt == 0:  # isolated landmark: self-loop carries no force
                cn[a, :] = a
        return cn, cw

    def _hier_init(self, nbrs, dist, w, rng) -> np.ndarray:
        p = self.params
        n = nbrs.shape[0]
        m = p.n_landmarks or int(np.clip(n // 32, 1024, 16384))
        m = min(m, n)
        marks = rng.choice(n, size=m, replace=False)
        lab = self._assign_landmarks(nbrs, dist, marks)
        cn, cw = self._coarse_graph(nbrs, w, lab, m)
        log.info("hierarchical init: %d landmarks, coarse graph built", m)
        y0c = self._dmap_init(np.maximum(cw, 1e-9), cn)
        yc = self._optimize(cn, cw, y0c, rng_seed=self.seed + 1)
        # fine points start at their landmark, jittered by the coarse
        # layout's local scale so clusters are blobs, not points
        ext = float(np.abs(yc).max()) or 1.0
        y = yc[lab] + rng.normal(size=(n, p.dim)).astype(np.float32) * (0.01 * ext)
        return y.astype(np.float32)

    # -- optimisation ---------------------------------------------------------

    def _optimize(self, nbrs: np.ndarray, w: np.ndarray, y0: np.ndarray, rng_seed: int,
                  negatives: torch.Tensor | None = None) -> np.ndarray:
        """Full-batch UMAP-style layout of one graph level on the device.
        `negatives` [total, nneg, n*k] replaces the draws (tests)."""
        p = self.params
        dev = self.device
        n, k = nbrs.shape
        dim = y0.shape[1]
        ew = w.ravel().astype(np.float32)
        # normalise so the strongest edge pulls with unit weight; zero-weight
        # pad edges (coarse graphs) contribute nothing
        ew = ew / max(float(ew.max()), 1e-12)
        total = max(int(p.nb_grad_batch * p.epochs_per_batch), 1)
        nneg = max(int(p.nb_sampling_by_edge), 1)
        n_edges = n * k
        src = torch.arange(n, device=dev).repeat_interleave(k)
        dst = torch.from_numpy(nbrs.ravel().astype(np.int64)).to(dev)
        by_dst = torch.sort(dst, stable=True).indices
        dst_len = torch.bincount(dst, minlength=n)
        ew_t = torch.from_numpy(ew).to(dev)[:, None]
        beta2 = torch.tensor(-2.0 * np.float32(p.beta), dtype=torch.float32, device=dev)
        nneg_t = torch.tensor(float(nneg), dtype=torch.float32, device=dev)
        # the scatter-add sums ~k clipped per-edge forces a point: scale by 1/k
        base_lr = np.float32(p.grad_step / (4.0 * k))
        gen = torch.Generator(device=dev).manual_seed(int(rng_seed))
        y = torch.from_numpy(np.ascontiguousarray(y0, dtype=np.float32)).to(dev)
        for t in range(total):
            yi = y[src]
            diff = yi - y[dst]
            d2 = (diff * diff).sum(-1, keepdim=True)
            # attraction: UMAP's gradient (a = b = 1) scaled by beta,
            # each component clipped to +-4
            attr = ew_t * torch.clamp(beta2 * diff / (1.0 + d2), -4.0, 4.0)
            g = attr.view(n, k, dim).sum(1)
            g = g - torch.segment_reduce(attr[by_dst], "sum", lengths=dst_len)
            negs = (negatives[t].to(dev) if negatives is not None else
                    torch.randint(0, n, (nneg, n_edges), generator=gen, device=dev))
            for r in range(nneg):
                diffn = yi - y[negs[r]]
                dn2 = (diffn * diffn).sum(-1, keepdim=True)
                rep = torch.clamp(2.0 * diffn / ((0.01 + dn2) * (1.0 + dn2)), -4.0, 4.0)
                g = g + (rep / nneg_t).view(n, k, dim).sum(1)
            lr = base_lr * (np.float32(1.0) - np.float32(t) / np.float32(total))
            y = y + float(lr) * g
        return y.cpu().numpy()

    def embed(self) -> np.ndarray:
        p = self.params
        nbrs = self.kgraph.neighbors.astype(np.int32)
        dist = self.kgraph.distances
        t0 = time.perf_counter()
        w = self._edge_weights()
        n = nbrs.shape[0]
        rng = np.random.default_rng(self.seed)
        if n > p.hier_threshold:
            y0 = self._hier_init(nbrs, dist, w, rng)
        elif p.dmap_init:
            y0 = self._dmap_init(w, nbrs)
        else:
            y0 = rng.normal(size=(n, p.dim)).astype(np.float32) * 10
        t1 = time.perf_counter()
        self._embedded = self._optimize(nbrs, w, y0, rng_seed=self.seed)
        self.times = {"init_s": t1 - t0, "optimize_s": time.perf_counter() - t1}
        return self._embedded

    def get_embedded_reindexed(self) -> np.ndarray:
        assert self._embedded is not None
        return self._embedded

    def get_quality_estimate_from_edge_length(self, nb_sample: int = 200) -> float:
        """Mean embedded length of graph edges over the mean length of
        random pairs: small is good."""
        assert self._embedded is not None
        y = self._embedded
        rng = np.random.default_rng(1)
        e_len = np.linalg.norm(y[self.kgraph.neighbors[:, 0]] - y, axis=1).mean()
        a = rng.integers(0, len(y), nb_sample)
        b = rng.integers(0, len(y), nb_sample)
        r_len = np.linalg.norm(y[a] - y[b], axis=1).mean()
        return float(e_len / max(r_len, 1e-12))


def get_graph_stats_embed(
    db_dir: str,
    ask_stats: bool = True,
    embed: bool = False,
    knbn: int = 8,
    params: EmbedderParams | None = None,
    out_dir: str = ".",
    *,
    device: torch.device,
) -> dict:
    """The `ann` workflow: k-NN graph, its statistics and hubness, and with
    `embed` the 2-D layout written to database_embedded.csv."""
    from ..index.serialize import load_index

    index = load_index(db_dir, device)
    kgraph = kgraph_from_index(index, knbn=knbn)
    del index
    stats = kgraph.stats()
    hub = Hubness(kgraph)
    s3m = hub.get_standard3m()
    hist = hub.get_hubness_histogram()
    summary = (
        f"kgraph: {stats['nb_nodes']} nodes, knbn={knbn}; "
        f"first-dist median {stats['first_dist_quantiles']['0.5']:.4f}; "
        f"hubness (standard 3rd moment): {s3m:.3e}"
    )
    result = {"stats": stats, "hubness_s3m": s3m, "hubness_hist": hist.tolist(), "summary": summary}
    if embed:
        embedder = Embedder(kgraph, params, device=device)
        y = embedder.embed()
        csv_path = os.path.join(out_dir, "database_embedded.csv")
        np.savetxt(csv_path, y, delimiter=",", fmt="%.6e")
        q = embedder.get_quality_estimate_from_edge_length(200)
        result["embedded_csv"] = csv_path
        result["quality"] = q
        result["summary"] += f"; embedded -> {csv_path} (quality {q:.3f})"
    return result
