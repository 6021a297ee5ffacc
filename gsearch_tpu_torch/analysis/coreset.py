"""Coreset extraction and clustering over a sketch database.

Counterpart of gsearch_tpu/analysis/coreset.py: a D^2-sampled coreset
(each round scores every point against the new centres and draws the next
ones with probability proportional to the squared distance to the nearest
centre), assignment weights, then a weighted medoid clustering of the
coreset and the dispatch of every point to the final medoids.  The draws
and the medoid loop stay on the host with `np.random.default_rng(seed)`,
as in the reference; every distance block is computed on the device from
signatures uploaded once (each function takes the host matrix, or the
device rows `metric_rows` made of it, so that callers share one upload).

Metrics: `hamming` (the sketch metric) is K1 (`ops/distance.hamming_frac`)
on the slots' 32-bit patterns; `l1`, `l2` and `cosine` read the signatures
by value as f32 (a u32 or u16 slot becomes its integer value), as the
reference converts them, and are plain products (`l1` in blocks of 512
rows).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.distance import as_int32_rows, hamming_frac
from ..utils import get_logger

log = get_logger(__name__)

METRICS = ("hamming", "l1", "l2", "cosine")


def metric_rows(sigs: np.ndarray, metric: str, device: torch.device) -> torch.Tensor:
    """Host signature rows in the form `pairwise_distance` takes for
    `metric`, on `device`: int32 bit patterns for hamming, f32 values
    otherwise."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}: expected hamming | l1 | l2 | cosine")
    if metric == "hamming":
        return as_int32_rows(sigs).to(device)
    return torch.from_numpy(np.ascontiguousarray(sigs, dtype=np.float32)).to(device)


def _device_rows(sigs, metric: str, device: torch.device) -> torch.Tensor:
    """sigs as given (a tensor already in `metric_rows` form) or uploaded."""
    return sigs if isinstance(sigs, torch.Tensor) else metric_rows(sigs, metric, device)


def pairwise_distance(q: torch.Tensor, db: torch.Tensor, metric: str = "hamming") -> torch.Tensor:
    """Dense [Q, N] distance block under `metric`, q and db in the form
    `metric_rows` gives."""
    if metric == "hamming":
        return hamming_frac(q, db)
    if metric == "l2":
        sq = (q * q).sum(-1)[:, None] + (db * db).sum(-1)[None, :]
        d2 = sq - 2.0 * (q @ db.T)
        return torch.sqrt(torch.clamp_min(d2, 0.0))
    if metric == "cosine":
        qn = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), 1e-30)
        dn = db / torch.clamp_min(torch.linalg.norm(db, dim=-1, keepdim=True), 1e-30)
        return 1.0 - qn @ dn.T
    if metric == "l1":
        return torch.cat([(q[:, None, :] - db[None, st : st + 512, :]).abs().sum(-1)
                          for st in range(0, db.shape[0], 512)], dim=1)
    raise ValueError(f"unknown metric {metric!r}: expected hamming | l1 | l2 | cosine")


def _block(rows: torch.Tensor, ids, db: torch.Tensor, metric: str) -> np.ndarray:
    """Distances of the rows `ids` of `rows` to db, on the host."""
    sel = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=rows.device)
    return pairwise_distance(rows[sel], db, metric).cpu().numpy()


@dataclasses.dataclass
class CoresetResult:
    ids: np.ndarray          # [C] database ids of coreset points
    weights: np.ndarray      # [C] number of points assigned
    assignment: np.ndarray   # [N] coreset member index per point
    cost: float              # sum of assignment distances


def distance_quantiles(sigs: np.ndarray, nb_rows: int = 256, seed: int = 0,
                       metric: str = "hamming", *, device: torch.device) -> dict:
    """Sampled pairwise-distance quantiles: nb_rows random rows scored
    against the whole database in one block."""
    rng = np.random.default_rng(seed)
    n = sigs.shape[0]
    rows = rng.choice(n, size=min(nb_rows, n), replace=False)
    dev_rows = _device_rows(sigs, metric, device)
    d = _block(dev_rows, rows, dev_rows, metric)
    qs = [0.01, 0.05, 0.25, 0.5, 0.75, 0.95, 0.99]
    return {str(q): float(np.quantile(d.ravel(), q)) for q in qs}


def build_coreset(sigs: np.ndarray, nb_coreset: int, seed: int = 0, metric: str = "hamming",
                  *, device: torch.device) -> CoresetResult:
    """D^2-sampled coreset with assignment weights; centres are drawn in
    rounds that double the coreset, one device sweep a round."""
    rng = np.random.default_rng(seed)
    n = sigs.shape[0]
    c = min(nb_coreset, n)
    dev_rows = _device_rows(sigs, metric, device)
    chosen = [int(rng.integers(0, n))]
    best_d = _block(dev_rows, chosen, dev_rows, metric)[0]
    while len(chosen) < c:
        batch = min(max(1, len(chosen)), c - len(chosen))
        p = best_d.astype(np.float64) ** 2
        p_sum = p.sum()
        if p_sum <= 0:
            extra = rng.choice(n, size=batch, replace=False)
        else:
            extra = rng.choice(n, size=batch, replace=False, p=p / p_sum)
        chosen.extend(int(e) for e in extra)
        best_d = np.minimum(best_d, _block(dev_rows, extra, dev_rows, metric).min(axis=0))
    ids = np.array(sorted(set(chosen))[:c], dtype=np.int64)
    d_all = _block(dev_rows, ids, dev_rows, metric)  # [C, N]
    assignment = d_all.argmin(axis=0)
    weights = np.bincount(assignment, minlength=len(ids))
    cost = float(d_all.min(axis=0).sum())
    return CoresetResult(ids=ids, weights=weights, assignment=assignment, cost=cost)


def cluster_coreset(sigs: np.ndarray, coreset: CoresetResult, nb_cluster: int,
                    nb_iter: int = 10, seed: int = 0, metric: str = "hamming",
                    *, device: torch.device) -> CoresetResult:
    """Weighted medoid clustering of the coreset, then the dispatch of all
    points to the final medoids."""
    rng = np.random.default_rng(seed)
    c = len(coreset.ids)
    k = min(nb_cluster, c)
    w = coreset.weights.astype(np.float64)
    dev_rows = _device_rows(sigs, metric, device)
    core = dev_rows[torch.as_tensor(coreset.ids, device=device)]
    d_cc = pairwise_distance(core, core, metric).cpu().numpy()
    medoids = list(rng.choice(c, size=k, replace=False))
    for _ in range(nb_iter):
        assign = d_cc[:, medoids].argmin(axis=1)
        new_medoids = []
        for j in range(k):
            members = np.where(assign == j)[0]
            if len(members) == 0:
                new_medoids.append(medoids[j])
                continue
            # weighted 1-medoid of the members
            sub = d_cc[np.ix_(members, members)] * w[members][None, :]
            new_medoids.append(int(members[sub.sum(axis=1).argmin()]))
        if new_medoids == medoids:
            break
        medoids = new_medoids
    medoid_ids = coreset.ids[medoids]
    d_all = _block(dev_rows, medoid_ids, dev_rows, metric)
    assignment = d_all.argmin(axis=0)
    weights = np.bincount(assignment, minlength=k)
    return CoresetResult(ids=medoid_ids, weights=weights, assignment=assignment,
                         cost=float(d_all.min(axis=0).sum()))


def dump_coreset_csv(res: CoresetResult, seqdict, path: str) -> None:
    with open(path, "w") as f:
        f.write("coreset_rank,data_id,path,weight\n")
        for rank, (i, w) in enumerate(zip(res.ids, res.weights)):
            f.write(f"{rank},{i},{seqdict[int(i)].id.path},{int(w)}\n")


def dump_cluster_csv(res: CoresetResult, seqdict, path: str) -> None:
    with open(path, "w") as f:
        f.write("data_id,path,cluster,medoid_data_id,medoid_path\n")
        for i, a in enumerate(res.assignment):
            m = int(res.ids[int(a)])
            f.write(f"{i},{seqdict[i].id.path},{int(a)},{m},{seqdict[m].id.path}\n")
