"""The numbers that decide `correct`, each held to a limit of its cell
(`limits/<cell>.json`): what the timed path produced, against the plain
references in `reference/`.

Search answers (one row of k per query):
- `bad_answers`: rows that are not a valid answer: wrong shape, an id
  outside the database, an id twice, a distance that is not finite or out
  of ascending order;
- `dist_gap`: the widest gap between a reported distance and the exact
  distance 1 - eq/S of the genome it names;
- `near_miss`: of the exact k nearest that lie below `near` (the species
  level, `species_distance`), the share the answer misses: at rank j, the
  j-th best of the answer's exact equal-slot counts is below the exact
  search's (ties count as found).  It sees the candidate stage: the
  distances of a wrong candidate list are still exact;
- `miss_share`: the same over the exact k nearest within the answer
  filter (distance below `threshold`, the request's output cut); printed,
  not compared (the tiers' candidate lists lose far neighbours by design).

Sketches (one signature per genome and pass):
- `slot_mismatch`: slots whose bits differ from the reference's, compared
  as unsigned integers of the reference's slot width;
- `bad_passes`: passes whose database lacks a genome, holds a wrong count
  or keeps its slots in another dtype than the reference's.
"""

from __future__ import annotations

import math

import numpy as np


def species_distance(kmer: int, ani: float = 0.95) -> float:
    """The distance 1 - J at which two genomes sit at `ani`, by gsearch's
    conversion ANI = 1 + ln(2J / (1 + J)) / k: 0.7103 at k = 16."""
    e = math.exp(kmer * (ani - 1.0))
    return 1.0 - e / (2.0 - e)


def bad_rows(d: np.ndarray, ids: np.ndarray, n: int, k: int) -> np.ndarray:
    """Mask [Q] of rows that are no valid answer."""
    q = d.shape[0]
    if d.shape != (q, k) or ids.shape != (q, k):
        return np.ones(q, bool)
    bad = ~np.isfinite(d).all(1) | (ids < 0).any(1) | (ids >= n).any(1)
    bad |= (np.diff(d, axis=1) < 0).any(1)
    s = np.sort(ids, axis=1)
    bad |= (s[:, 1:] == s[:, :-1]).any(1)
    return bad


def search_numbers(ref, queries: np.ndarray, d: np.ndarray, ids: np.ndarray, *, k: int,
                   threshold: float, near: float) -> dict:
    """ref: reference.knn.ExactKnn over the database; queries [Q, S] and
    the program's answers d, ids [Q, k] for them."""
    n, s = ref.n, ref.s
    bad = bad_rows(d, ids, n, k)
    ok = ~bad
    out = {"bad_answers": int(bad.sum()), "dist_gap": 0.0, "near_miss": 0.0, "miss_share": 0.0,
           "judged_rows": int(ok.sum())}
    if not ok.any():
        return out
    q, d, ids = queries[ok], d[ok].astype(np.float64), ids[ok]
    eq = ref.eq_of(q, ids)                     # exact counts of the returned genomes
    out["dist_gap"] = float(np.abs(d - (1.0 - eq / s)).max())
    want, _ = ref.top(q, k)                    # exact counts of the k nearest, descending
    got = -np.sort(-eq, axis=1)
    dist = 1.0 - want / s
    for name, cut in (("near_miss", near), ("miss_share", threshold)):
        relevant = dist < cut
        out[name] = float((relevant & (got < want)).sum() / max(1, relevant.sum()))
        out[name.split("_")[0] + "_relevant"] = int(relevant.sum())
    return out


def sketch_numbers(ref_sigs: np.ndarray, passes: list, expected: int) -> dict:
    """ref_sigs [G, S] of the judged genomes in the reference's dtype;
    passes: per pass either None (no database) or (sigs [G, S] of the same
    genomes, nb_points)."""
    mismatch, bad = 0, 0
    bits = np.dtype(f"u{ref_sigs.dtype.itemsize}")
    want = ref_sigs.view(bits)
    for p in passes:
        if p is None or p[1] != expected or p[0].shape != ref_sigs.shape or p[0].dtype != ref_sigs.dtype:
            bad += 1
            continue
        mismatch += int((p[0].view(bits) != want).sum())
    return {"slot_mismatch": mismatch, "bad_passes": bad, "passes": len(passes)}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every limited number at or under
    its limit; a number that is missing fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name)
        rows.append((name, value, limit))
        if value is None or not value <= limit:
            ok = False
    return ok, rows
