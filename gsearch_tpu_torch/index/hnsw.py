"""Graph index: gsearch's HNSW role on one torch device.

Counterpart of gsearch_tpu/index/hnsw.py, with the same graph, the same
construction passes and the same search routes:

* The base layer is one flat int32 neighbour array [N, M0]; the upper
  HNSW layers are replaced by an entry tier, a deterministic golden-stride
  sample of nodes (plus pinned novel-cluster points) searched exactly.
* Traversal is a batched multi-query beam search on a signature prefix:
  each hop expands E beam nodes per query, drops candidates already in the
  visited ring, the beam or earlier in the hop block, scores the rest
  through K2 (`gather_hamming`, K1 for the entry tier) and merges.  The
  reference's `while_loop` is a host loop here, one `.any()` sync per hop,
  with the same termination test and `hops` cap.
* The top candidates are reranked on the device by one of four tiers that
  `_rerank_tier` picks from the reference's byte budgets: the full
  signatures (K2 `parts=1`), or 16-, 8- or 4-bit slot hashes (K2
  `parts=2, 4, 8`); with none of them, on the host.  The packed tiers'
  answers are re-scored exactly on the host, packed4 over a 32-wide window.
* On CUDA, databases of at least COARSE_MIN points take the coarse route
  instead of the beam: an exact prefix-metric top-r sweep by `MxuSearcher`
  (int8 matmul + K2 rerank) feeds the rerank tier, in id order, so that
  distance ties come back by id as from the flat index (the reference
  enables that route on a TPU and orders ties by coarse rank); on the CPU
  both take the beam.
* Construction: batched beam inserts (`_insert_search` on the device, the
  forward/reverse link selection on the host, `_insert_apply` on the
  device), or for large fresh builds and appends the bulk path: an exact
  top-C sweep by a compact `MxuSearcher` (K2 `parts=2`), the select-
  neighbours heuristic on the device (`_bulk_keep`, pair distances through
  K1's self-pair form) and one host-vectorised reverse merge.

The numpy host helpers are copies of the reference's.  Rules that make the
port deterministic where the reference leaves it to XLA:
* top-k and argsort keep the lower index first among equal keys (a stable
  sort), as `jax.lax.top_k` and `jnp.argsort` do;
* scatters with repeated targets keep the last write in index order, which
  is what XLA does on the CPU (`_set_rows`, `_set_cells`).
Results of the bulk path can differ from the reference's at distance ties
only: `MxuSearcher` orders ties by id, the reference by candidate score.
"""

from __future__ import annotations

import math
import time
import zlib
from typing import Tuple

import numpy as np
import torch

from ..ops import host_rescore
from ..ops.distance import (as_int32_rows, bucketed_knn, gather_hamming, hamming_frac,
                            hamming_frac_self, sig_bits, topk_smallest)
from ..ops.mxu import (MxuSearcher, _next_pow2, _round_up, pack_hash4, pack_hash8, pack_hash16,
                       planned_footprint)
from ..ops.query_stage import QueryStager
from ..utils import get_logger, trace
from .sigfile import load_sigs, save_sigs

log = get_logger(__name__)

_PAD = -1  # host-side padding for absent neighbors

# device full-signature rerank is used when the whole signature matrix (the
# reference's padded layout) fits in this many bytes
_RERANK_DEVICE_BYTES = 13_000_000_000

_PACKERS = {16: pack_hash16, 8: pack_hash8, 4: pack_hash4}


# ---------------------------------------------------------------------------
# host helpers (copies of gsearch_tpu/index/hnsw.py)
# ---------------------------------------------------------------------------


def _forward_rows(cand_ids, cand_d, keep, *, base, valid_limit, n_total,
                  m0, m_near, sent, b_real):
    """Vectorized forward-link selection for a batch of points with ids
    base..base+B (shared by the incremental insert and the bulk build).

    Partitioned rows: near region [0, m_near) holds the nearest candidates
    (pruned ones included); the far region [m_near, m0) the heuristic's
    survivors beyond the near cutoff, then next-nearest pruned ones; the
    tail, degree-4 pseudo-random long links (golden-stride in the node id)."""
    B = cand_ids.shape[0]
    cand_d = np.array(cand_d)
    # invalidate pad-mates (ids beyond the live set) and self refs
    cand_d[cand_ids >= valid_limit] = np.inf
    finite = np.isfinite(cand_d)
    good = keep & finite
    rows_ids = np.full((B, m0), sent, dtype=np.int32)
    rows_d = np.full((B, m0), np.inf, dtype=np.float32)
    fin_rank = np.cumsum(finite, axis=1) - 1
    near_take = finite & (fin_rank < m_near)
    r_i, _ = np.nonzero(near_take)
    rows_ids[r_i, fin_rank[near_take]] = cand_ids[near_take]
    rows_d[r_i, fin_rank[near_take]] = cand_d[near_take]
    m_far = m0 - m_near
    beyond = finite & (fin_rank >= m_near)
    key = np.where(beyond & good, np.int8(0),
                   np.where(beyond, np.int8(1), np.int8(2)))
    o2 = np.argsort(key, axis=1, kind="stable")
    far_ids = np.take_along_axis(cand_ids, o2, axis=1)[:, :m_far]
    far_d = np.take_along_axis(cand_d, o2, axis=1)[:, :m_far]
    far_ok = np.take_along_axis(key < 2, o2, axis=1)[:, :m_far]
    rows_ids[:, m_near:] = np.where(far_ok, far_ids, sent)
    rows_d[:, m_near:] = np.where(far_ok, far_d.astype(np.float32), np.inf)
    rl = min(4, m_far)
    me_col = (base + np.arange(B, dtype=np.uint64))[:, None]
    jj = np.arange(1, rl + 1, dtype=np.uint64)[None, :]
    rnd = ((me_col * np.uint64(0x9E3779B1) + jj * np.uint64(0x85EBCA77))
           % np.uint64(n_total)).astype(np.int32)
    rnd = np.where(rnd == (base + np.arange(B))[:, None],
                   (rnd + 1) % n_total, rnd)
    rows_ids[:, m0 - rl:] = rnd
    rows_d[:, m0 - rl:] = np.inf
    if b_real < B:
        rows_ids[b_real:] = sent
        rows_d[b_real:] = np.inf
    return rows_ids, rows_d


def _group_reverse(rows_ids, rows_d, *, base, b_real, mmax, rin, sent):
    """Group a batch's reverse links by target: sorted (target, dist)
    triples, capped at `rin` incoming per target."""
    B, _ = rows_ids.shape
    me = (base + np.arange(B, dtype=np.int32))[:, None]
    valid = (rows_ids != sent) & (me < base + b_real)
    # reverse only the closest `max_nb_conn` forward links
    valid[:, mmax:] = False
    tgt = rows_ids[valid]
    src = np.broadcast_to(me, rows_ids.shape)[valid]
    dd = rows_d[valid]
    ub = B * mmax
    inc_tgt = np.full(ub, sent, np.int32)
    inc_ids = np.full((ub, rin), sent, np.int32)
    inc_d = np.full((ub, rin), np.inf, np.float32)
    if tgt.size:
        o = np.lexsort((dd, tgt))
        tgt, src, dd = tgt[o], src[o], dd[o]
        first = np.empty(len(tgt), bool)
        first[0] = True
        np.not_equal(tgt[1:], tgt[:-1], out=first[1:])
        seg = np.cumsum(first) - 1
        seg_start = np.flatnonzero(first)
        rank = np.arange(len(tgt)) - seg_start[seg]
        sel = rank < rin
        u = int(seg[-1]) + 1
        inc_tgt[:u] = tgt[first]
        inc_ids[seg[sel], rank[sel]] = src[sel]
        inc_d[seg[sel], rank[sel]] = dd[sel]
    return inc_tgt, inc_ids, inc_d


def _global_reverse_merge(rows_all: np.ndarray, rowsd_all: np.ndarray, *,
                          base_src: int, rin: int, mmax: int, m_near: int,
                          sent: int) -> None:
    """One capped host-vectorized reverse merge: every forward link
    (src -> tgt) of rows src >= base_src becomes a candidate back-link
    (tgt -> src), merged into tgt's near region by distance with dup
    suppression.  Mutates rows_all/rowsd_all in place."""
    tgt = rows_all[base_src:, :mmax].ravel()
    dd = rowsd_all[base_src:, :mmax].ravel()
    src = np.repeat(np.arange(base_src, rows_all.shape[0], dtype=np.int32), mmax)
    ok = (tgt != sent) & np.isfinite(dd)
    tgt, dd, src = tgt[ok], dd[ok], src[ok]
    if not tgt.size:
        return
    o = np.lexsort((dd, tgt))
    tgt, dd, src = tgt[o], dd[o], src[o]
    first = np.empty(len(tgt), bool)
    first[0] = True
    np.not_equal(tgt[1:], tgt[:-1], out=first[1:])
    seg = np.cumsum(first) - 1
    seg_start = np.flatnonzero(first)
    rank = np.arange(len(tgt)) - seg_start[seg]
    sel = rank < rin
    u = int(seg[-1]) + 1
    inc_tgt = tgt[first]
    inc_ids = np.full((u, rin), sent, np.int32)
    inc_d = np.full((u, rin), np.inf, np.float32)
    inc_ids[seg[sel], rank[sel]] = src[sel]
    inc_d[seg[sel], rank[sel]] = dd[sel]
    for cstart in range(0, u, 65536):  # chunk the [U, rin, m_near] dup mask
        ct = inc_tgt[cstart : cstart + 65536]
        ci = inc_ids[cstart : cstart + 65536]
        cdv = inc_d[cstart : cstart + 65536].copy()
        ex_ids = rows_all[ct, :m_near]
        ex_d = rowsd_all[ct, :m_near]
        dup = (ci[:, :, None] == ex_ids[:, None, :]).any(-1)
        cdv[dup] = np.inf
        comb_ids = np.concatenate([ex_ids, ci], axis=1)
        comb_d = np.concatenate([ex_d, cdv], axis=1)
        oc = np.argsort(comb_d, axis=1, kind="stable")[:, :m_near]
        mids = np.take_along_axis(comb_ids, oc, 1)
        md = np.take_along_axis(comb_d, oc, 1)
        mids = np.where(np.isfinite(md), mids, sent)
        rows_all[ct, :m_near] = mids
        rowsd_all[ct, :m_near] = md


# ---------------------------------------------------------------------------
# device building blocks (the reference's traced functions)
# ---------------------------------------------------------------------------


def _last_writes(key: torch.Tensor) -> torch.Tensor:
    """Positions of the LAST occurrence of each distinct key, the write
    that wins a scatter in XLA's order on the CPU; scattering only these
    makes the result independent of the backend."""
    _, order = torch.sort(key, stable=True)
    sk = key[order]
    last = torch.ones_like(sk, dtype=torch.bool)
    last[:-1] = sk[1:] != sk[:-1]
    return order[last]


def _set_rows(dst: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor) -> None:
    """dst[rows] = vals, the last write winning at a repeated row."""
    keep = _last_writes(rows)
    dst[rows[keep]] = vals[keep]


def _set_cells(dst: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
               vals: torch.Tensor) -> None:
    """dst[rows, cols] = vals, the last write winning at a repeated cell."""
    keep = _last_writes(rows * dst.shape[1] + cols)
    dst[rows[keep], cols[keep]] = vals[keep]


def _repeats(x: torch.Tensor) -> torch.Tensor:
    """True where x[i, j] equals an earlier x[i, j'] (j' < j) of its row."""
    sx, order = torch.sort(x, dim=1, stable=True)
    dup = torch.zeros_like(sx, dtype=torch.bool)
    dup[:, 1:] = sx[:, 1:] == sx[:, :-1]
    return torch.empty_like(dup).scatter_(1, order, dup)


def _beam(sigs_p, nbrs_p, entries, q_p, n, *, ef, hops, expand, stats=None):
    """Batched beam search over the flat neighbor array.

    sigs_p [NB+1, S'] int32 (sentinel last), nbrs_p [NB+1, M0] int32
    (sentinel id = NB or more), entries [T] int32 (sentinel-padded), q_p
    [Q, S'] int32, n the live count.  Returns (beam_ids [Q, ef] int32,
    beam_d [Q, ef] f32) sorted ascending by prefix distance; `stats`, if
    given, receives the hop count."""
    qn = q_p.shape[0]
    m0 = nbrs_p.shape[1]
    sent = sigs_p.shape[0] - 1
    inf = torch.inf
    width = expand * m0

    # ---- entry tier: exact prefix distances to the sampled entries (K1)
    d_ent = hamming_frac(q_p, sigs_p[entries.long()])  # [Q, T]
    d_ent = torch.where((entries < n)[None, :], d_ent, inf)
    k0 = min(ef, entries.shape[0])
    beam_d, idx = topk_smallest(d_ent, k0)
    beam_ids = entries[idx]
    if k0 < ef:
        pad = ef - k0
        beam_ids = torch.cat([beam_ids, beam_ids.new_full((qn, pad), sent)], 1)
        beam_d = torch.cat([beam_d, beam_d.new_full((qn, pad), inf)], 1)
    expanded = (beam_ids >= n) | ~torch.isfinite(beam_d)

    # visited ring: everything ever scored (wraparound re-scores, as in the
    # reference); membership through one sorted search per hop, keyed by
    # (query, id) so all queries share it
    vis_size = _round_up(min(ef + hops * width, max(4096, ef + width + 128)), 128)
    ring = beam_ids.new_full((qn, vis_size), sent)
    ring[:, :ef] = beam_ids
    ring_pos = ef % max(vis_size - width, 1)
    row_key = torch.arange(qn, dtype=torch.int64, device=q_p.device)[:, None] * (sent + 1)

    it = 0
    while it < hops:
        # standard HNSW termination, batched: a query still has work while
        # its closest UNEXPANDED beam entry beats its worst kept result
        best_unexp = torch.where(expanded, inf, beam_d).min(1).values
        active = (best_unexp <= beam_d[:, -1]) & torch.isfinite(best_unexp)
        if not bool(active.any()):
            break
        _, sel = topk_smallest(torch.where(expanded, inf, beam_d), expand)  # [Q, E]
        sel_ids = beam_ids.gather(1, sel)
        expanded = expanded.scatter(1, sel, True)

        cand = nbrs_p[sel_ids.long()].reshape(qn, width)
        key = row_key + cand
        seen = torch.isin(key, row_key + ring)
        in_beam = torch.isin(key, row_key + beam_ids)
        fresh = ~seen & ~in_beam & ~_repeats(cand) & (cand < n)
        cand = torch.where(fresh, cand, sent)
        cd = torch.where(fresh, gather_hamming(sigs_p, q_p, cand), inf)  # K2

        all_ids = torch.cat([beam_ids, cand], 1)
        all_x = torch.cat([expanded, ~fresh], 1)
        beam_d, keep = topk_smallest(torch.cat([beam_d, cd], 1), ef)
        beam_ids = all_ids.gather(1, keep)
        expanded = all_x.gather(1, keep)

        ring[:, ring_pos : ring_pos + width] = cand
        ring_pos = (ring_pos + width) % max(vis_size - width, 1)
        it += 1
    if stats is not None:
        stats["hops"] = it
    return beam_ids, beam_d


def _insert_search(sigs_p, nbrs_p, entries, q_p, n, *, ef, C, hops, expand):
    """Build-time candidate generation for one insert batch.

    Writes the batch prefix sigs at row n (in place, so batch-mates are
    gatherable), beam-searches the existing graph, merges the dense
    batch-mate block, takes the top-C candidates and runs the select-
    neighbors heuristic.  Returns (cand_ids [B, C], cand_d [B, C], keep
    [B, C])."""
    B = q_p.shape[0]
    sigs_p[n : n + B] = q_p
    beam_ids, beam_d = _beam(sigs_p, nbrs_p, entries, q_p, n, ef=ef, hops=hops,
                             expand=expand)

    # ---- batch-mates as candidates: dense [B, B] prefix-distance block (K1 self pairs)
    d_m = hamming_frac_self(q_p)
    d_m.fill_diagonal_(torch.inf)
    mate_ids = n + torch.arange(B, dtype=torch.int32, device=q_p.device)
    all_ids = torch.cat([beam_ids, mate_ids.expand(B, B)], 1)
    cand_d, sel = topk_smallest(torch.cat([beam_d, d_m], 1), C)
    cand_ids = all_ids.gather(1, sel)

    # ---- candidate pairwise block (K1 self pairs, batched) + select heuristic
    finite = torch.isfinite(cand_d)
    cs = sigs_p[torch.where(finite, cand_ids, 0).long()]  # [B, C, S']
    pair_d = hamming_frac_self(cs)  # [B, C, C]
    kept = torch.zeros((B, C), dtype=torch.bool, device=q_p.device)
    kept[:, 0] = finite[:, 0]
    for j in range(1, C):
        # candidate j survives if closer to the node than to every kept one
        d_to_kept = torch.where(kept, pair_d[:, j, :], torch.inf)
        kept[:, j] = (cand_d[:, j] < d_to_kept.min(1).values) & finite[:, j]
    return cand_ids, cand_d, kept


def _reverse_merge_impl(nbrs_p, nbr_d, inc_tgt, inc_ids, inc_d, m_near) -> None:
    tgt = inc_tgt.long()
    ex_ids = nbrs_p[tgt, :m_near]
    ex_d = nbr_d[tgt, :m_near]
    # drop incoming links already present (batch-mate forward duplicates)
    dup = (inc_ids[:, :, None] == ex_ids[:, None, :]).any(-1)
    inc_d = torch.where(dup, torch.inf, inc_d)
    comb_ids = torch.cat([ex_ids, inc_ids], 1)
    md, sel = topk_smallest(torch.cat([ex_d, inc_d], 1), m_near)
    merged = torch.where(torch.isfinite(md), comb_ids.gather(1, sel), nbrs_p.shape[0] - 1)
    rows_new = torch.cat([merged, nbrs_p[tgt, m_near:]], 1)
    drow_new = torch.cat([md, nbr_d[tgt, m_near:]], 1)
    _set_rows(nbrs_p, tgt, rows_new)
    _set_rows(nbr_d, tgt, drow_new)


def _insert_apply(nbrs_p, nbr_d, rows_ids, rows_d, n, inc_tgt, inc_ids, inc_d,
                  f_tgt, f_src, f_d, *, m_near, rl) -> None:
    """Write the batch's forward rows at n and merge reverse links into
    their targets' near regions by cached link distance (in place); then
    the reachability guarantee: each inserted point forces ONE back-link
    from its nearest pre-batch neighbor into that row's tail slots."""
    B = rows_ids.shape[0]
    nbrs_p[n : n + B] = rows_ids
    nbr_d[n : n + B] = rows_d
    _reverse_merge_impl(nbrs_p, nbr_d, inc_tgt, inc_ids, inc_d, m_near)
    if rl > 0:
        m0 = nbrs_p.shape[1]
        tgt = f_tgt.long()
        tail_d = nbr_d[tgt, m0 - rl:]  # [B, rl]
        # slot = (mixed src % rl)-th in the distance-descending slot order
        order = torch.argsort(-tail_d, dim=1, stable=True)
        srl = (f_src ^ (f_src >> 4) ^ (f_src >> 9)) % rl
        slot = order.gather(1, srl[:, None].long())[:, 0]
        # already-present forced source (re-apply / duplicate): no-op slot
        here = nbrs_p[tgt, m0 - rl:] == f_src[:, None]
        slot = torch.where(here.any(1), here.to(torch.int8).argmax(1), slot) + (m0 - rl)
        _set_cells(nbrs_p, tgt, slot, f_src)
        _set_cells(nbr_d, tgt, slot, f_d)


def _bulk_keep(sigs_p, cand_ids, cand_d):
    """Select-neighbors heuristic over exact-kNN candidate lists (bulk
    build): keep candidate j iff it is closer to the query than to every
    already-kept candidate.  sigs_p [N, sp] int32; cand_ids [B, C] sorted
    ascending by cand_d (masked entries = inf).  Returns keep [B, C] bool.
    The pair distances 1 - eq/sp come from K1's self-pair form."""
    rows = sigs_p[cand_ids.long()]  # [B, C, sp]
    pair_d = hamming_frac_self(rows)  # [B, C(j), C(i)]
    closest = torch.full(cand_d.shape, torch.inf, device=cand_d.device)
    keeps = torch.empty(cand_d.shape, dtype=torch.bool, device=cand_d.device)
    for j in range(cand_d.shape[1]):
        kj = cand_d[:, j] < closest[:, j]
        closest = torch.where(kj[:, None], torch.minimum(closest, pair_d[:, j]), closest)
        keeps[:, j] = kj
    return keeps


def _graph_search(sigs_p, nbrs_p, entries, q_p, n, *, ef, r, hops, expand, stats=None):
    """Search-time traversal: beam on the prefix, the top-r candidates
    (prefix distances) for reranking."""
    beam_ids, beam_d = _beam(sigs_p, nbrs_p, entries, q_p, n, ef=ef, hops=hops,
                             expand=expand, stats=stats)
    return beam_d[:, :r], beam_ids[:, :r]


def _rerank_device(tier, q_form, ids, n, *, knbn, s_true, parts=1):
    """Full-signature (parts=1) or packed-hash (parts=2, 4, 8) rerank of the
    [Q, R] candidates through K2, then the top-k."""
    ids = ids.to(torch.int32).contiguous()
    d = gather_hamming(tier, q_form, ids, parts=parts, s_true=s_true)
    d = torch.where(ids < n, d, torch.inf)
    vals, sel = topk_smallest(d, knbn)
    return vals, ids.gather(1, sel)


# ---------------------------------------------------------------------------
# the index
# ---------------------------------------------------------------------------


class HnswIndex:
    KIND = "hnsw"

    #: search-time beam width when the caller does not pass ef_search
    DEFAULT_EF = 256
    #: beam nodes expanded per hop (E); hops scale as ef / E
    EXPAND = 4
    #: entry-tier sizing multiplier
    ENTRY_MULT = 1.0
    #: fresh builds at least this large take the bulk constructor
    BULK_MIN = 32768
    #: appends at least this large take the bulk append
    BULK_ADD_MIN = 4096
    #: novelty threshold for entry pinning
    PIN_D = 0.98
    #: databases at least this large take the coarse route on CUDA
    COARSE_MIN = 65536
    #: device budget of the coarse searcher's representations
    COARSE_BYTES = 6_500_000_000

    def __init__(
        self,
        sketch_size: int,
        sig_dtype,
        max_nb_conn: int = 64,
        ef_construction: int = 200,
        scale_modification: float = 1.0,
        search_prefix: int = 1024,
        *,
        device: torch.device,
    ):
        self.sketch_size = sketch_size
        self.sig_dtype = np.dtype(sig_dtype)
        self.max_nb_conn = int(max_nb_conn)
        self.m0 = 2 * self.max_nb_conn  # base-layer degree, HNSW convention
        self.ef_construction = int(ef_construction)
        self.scale_modification = float(scale_modification)
        self.search_prefix = min(search_prefix, sketch_size)
        self.entry_tier_mult = self.ENTRY_MULT
        self.device = device
        self._sigs = np.empty((0, sketch_size), dtype=self.sig_dtype)
        self._nbrs = np.empty((0, self.m0), dtype=np.int32)
        self._nbr_d = np.empty((0, self.m0), dtype=np.float32)
        self._entry_ids = np.empty((0,), dtype=np.int32)
        # permanently-pinned entry ids (novel clusters, orphans)
        self._pinned = np.empty((0,), dtype=np.int32)
        self._device = None         # (sigs_p, nbrs_p, entries) for the beam
        self._device_full = None    # [n, S] int32 full signatures
        self._device_packed = None  # (w, bits, [n, w*bits/32] int32)
        self._coarse = None         # MxuSearcher over the prefix (False: won't fit)
        # upload-once prefix left by a bulk build/add: (n, [n, sp] int32, fp)
        self._prefix_dev = None
        self._sigs_buf = None       # capacity buffer backing self._sigs
        self._stager = QueryStager(device)  # query batches to the device
        #: what the last search and build did: route, tier, hops, stage seconds
        self.stats: dict = {}

    # ------------------------------------------------------------------ basics

    @property
    def nb_points(self) -> int:
        return self._sigs.shape[0]

    def get_sigs(self) -> np.ndarray:
        return self._sigs

    def adopt_sig_buffer(self, buf: np.ndarray, n: int) -> None:
        """Install a capacity buffer whose first n rows are the live
        signatures (load paths), so the first `add` does not migrate."""
        assert buf.shape[0] >= n and buf.shape[1] == self.sketch_size
        self._sigs_buf = buf
        self._sigs = buf[:n]

    def _append_sigs(self, new: np.ndarray) -> None:
        """Append rows in amortized O(new) through a capacity buffer with
        ~12.5% headroom (np.concatenate re-copies the whole matrix)."""
        n0 = self._sigs.shape[0]
        n1 = n0 + new.shape[0]
        buf = self._sigs_buf
        if not (buf is not None
                and (self._sigs is buf or self._sigs.base is buf)
                and self._sigs.ctypes.data == buf.ctypes.data
                and buf.shape[0] >= n1
                and buf.shape[1] == self.sketch_size):
            cap = n1 + max(n1 >> 3, 4096)
            buf = np.empty((cap, self.sketch_size), self.sig_dtype)
            buf[:n0] = self._sigs
            self._sigs_buf = buf
        buf[n0:n1] = new
        self._sigs = buf[:n1]

    def _sigs_fp(self) -> tuple:
        """Fingerprint of the host signature matrix guarding the _prefix_dev
        cache: its address and a CRC of every (n//64)-th row, so a
        reassigned matrix is caught even when it differs only in rows the
        reference's three-row sample skips."""
        n = self._sigs.shape[0]
        if n == 0:
            return (0, 0)
        fp = 0
        for r in range(0, n, max(1, n // 64)):
            fp = zlib.crc32(np.ascontiguousarray(self._sigs[r]).tobytes(), fp)
        return (self._sigs.ctypes.data, fp)

    def _cached_prefix(self, n: int):
        """The [n, search_prefix] int32 prefix a bulk build or add left on
        the device, or None when it no longer matches the host signatures."""
        c = self._prefix_dev
        if (c is not None and c[0] == n and tuple(c[1].shape) == (n, self.search_prefix)
                and c[2] == self._sigs_fp()):
            return c[1]
        return None

    def _entry_tier_size(self, n: int) -> int:
        if n <= 0:
            return 0
        base = max(math.sqrt(n), n / 64.0) / max(self.scale_modification, 0.2)
        base *= self.entry_tier_mult
        return int(min(n, max(16, base), 65536))

    def _entries_for(self, n: int) -> np.ndarray:
        t = self._entry_tier_size(n)
        if t == 0:
            return np.empty((0,), dtype=np.int32)
        # deterministic golden-stride sample (order-free)
        idx = (np.arange(t, dtype=np.uint64) * np.uint64(2654435761)) % np.uint64(n)
        pins = self._pinned[self._pinned < n]
        if pins.size:
            return np.unique(np.concatenate([idx.astype(np.int32), pins]))
        return np.unique(idx.astype(np.int32))

    def _refresh_entries(self) -> None:
        self._entry_ids = self._entries_for(self.nb_points)

    def _invalidate(self) -> None:
        self._device = None
        self._device_full = None
        self._device_packed = None
        self._coarse = None

    def _to_dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ------------------------------------------------------------------ build

    def insert(self, sigs: np.ndarray, batch_size: int = 1024,
               bulk: bool | None = None) -> None:
        """Batched graph construction.  Fresh builds of >= BULK_MIN points
        take the bulk path (_build_bulk), appends of >= BULK_ADD_MIN points
        the bulk append (_bulk_add); bulk=False forces beam inserts."""
        sigs = np.ascontiguousarray(sigs, dtype=self.sig_dtype)
        m = sigs.shape[0]
        if m == 0:
            return
        n0 = self.nb_points
        if bulk is None:
            bulk = m >= (self.BULK_MIN if n0 == 0 else self.BULK_ADD_MIN)
        if bulk:
            if n0 == 0:
                return self._build_bulk(sigs)
            return self._bulk_add(sigs)
        n_total = n0 + m
        B = min(_next_pow2(max(batch_size, 64)), _next_pow2(m))
        cap = _next_pow2(n_total)
        sent = cap + B  # sentinel row index; pad-batch rows live in [cap, sent)
        sp = self.search_prefix
        m0 = self.m0
        mmax = self.max_nb_conn

        ef_build = _round_up(min(max(self.ef_construction, 64), max(2 * m0, 64), cap), 64)
        C = min(_round_up(min(2 * m0, ef_build + B), 32), ef_build + B)
        expand = self.EXPAND
        hops = max(4, int(2 * math.log2(cap)) + ef_build // (2 * expand))
        tb = _next_pow2(max(self._entry_tier_size(sent), 16))
        rin = 4  # incoming reverse links kept per target per batch
        m_near = max(m0 - max(m0 // 4, min(8, m0 // 2)), rin)

        # --- device-resident build state ------------------------------------
        sigs_p = np.full((sent + 1, sp), -1, np.int32)
        sigs_p[:n0] = sig_bits(self._sigs[:, :sp])
        nbrs = np.full((sent + 1, m0), sent, np.int32)
        nbr_d = np.full((sent + 1, m0), np.inf, np.float32)
        if n0:
            nbrs[:n0] = np.where(self._nbrs == _PAD, sent, self._nbrs)
            self._ensure_nbr_d()
            nbr_d[:n0] = self._nbr_d
        d_sigs, d_nbrs, d_nbrd = self._to_dev(sigs_p), self._to_dev(nbrs), self._to_dev(nbr_d)
        del sigs_p, nbrs, nbr_d

        sigs_i32 = sig_bits(sigs[:, :sp])
        n = n0
        for start in range(0, m, B):
            b_real = min(B, m - start)
            q_p = np.full((B, sp), -1, np.int32)
            q_p[:b_real] = sigs_i32[start : start + b_real]
            entries = np.full(tb, sent, np.int32)
            e = self._entries_for(n)
            if len(e) > tb:  # pinned entries can exceed the entry buffer
                e = e[np.linspace(0, len(e) - 1, tb).astype(np.int64)]
            entries[: len(e)] = e

            cand_ids, cand_d, keep = _insert_search(
                d_sigs, d_nbrs, self._to_dev(entries), self._to_dev(q_p), n,
                ef=ef_build, C=C, hops=hops, expand=expand)
            cand_ids = cand_ids.cpu().numpy()
            cand_d = cand_d.cpu().numpy().copy()
            keep = keep.cpu().numpy()

            rows_ids, rows_d = _forward_rows(
                cand_ids, cand_d, keep, base=n, valid_limit=n + b_real,
                n_total=n_total, m0=m0, m_near=m_near, sent=sent,
                b_real=b_real)
            inc_tgt, inc_ids, inc_d = _group_reverse(
                rows_ids, rows_d, base=n, b_real=b_real, mmax=mmax, rin=rin,
                sent=sent)

            # reachability guarantee: nearest PRE-BATCH candidate of each
            # new point gets a forced back-link, spread over the 16 nearest
            # old candidates by source id
            old_ok = (cand_ids < n) & np.isfinite(cand_d)
            cum = np.cumsum(old_ok, axis=1)
            k_old = cum[:, -1]
            has_old = k_old > 0
            brow = np.arange(B)
            pick = (n + brow) % np.minimum(np.maximum(k_old, 1), 16) + 1
            fcol = np.argmax(cum == pick[:, None], axis=1)
            live = has_old & (brow < b_real)
            f_tgt = np.where(live, cand_ids[brow, fcol], sent).astype(np.int32)
            f_src = np.where(live, n + brow, sent).astype(np.int32)
            f_d = np.where(live, cand_d[brow, fcol], np.inf).astype(np.float32)

            # entry pinning: the first member of each novel cluster (nearest
            # pre-existing neighbor at >= PIN_D) joins the entry tier
            f_near = np.where(has_old, cand_d[brow, np.argmax(old_ok, 1)],
                              np.inf)
            novel = (brow < b_real) & (f_near >= self.PIN_D)
            mate_lt = ((cand_ids >= n) & (cand_ids < n + brow[:, None])
                       & (cand_d < self.PIN_D))
            new_pins = (n + brow)[novel & ~mate_lt.any(axis=1)]
            if new_pins.size:
                self._pinned = np.unique(
                    np.concatenate([self._pinned, new_pins.astype(np.int32)]))

            _insert_apply(
                d_nbrs, d_nbrd, self._to_dev(rows_ids), self._to_dev(rows_d), n,
                self._to_dev(inc_tgt), self._to_dev(inc_ids), self._to_dev(inc_d),
                self._to_dev(f_tgt), self._to_dev(f_src), self._to_dev(f_d),
                m_near=m_near, rl=min(4, m0 - m_near))
            n += b_real

        # ---- sync host mirrors, free device build state ---------------------
        nbrs_h = d_nbrs[:n_total].cpu().numpy()
        nbrd_h = d_nbrd[:n_total].cpu().numpy()
        self._nbrs = np.where(nbrs_h >= n_total, _PAD, nbrs_h).astype(np.int32)
        self._nbr_d = np.where(nbrs_h >= n_total, np.inf, nbrd_h).astype(np.float32)
        self._rescue_orphans(self._nbrs, self._nbr_d, rl=min(4, m0 - m_near))
        self._append_sigs(sigs)
        del d_sigs, d_nbrs, d_nbrd
        self._refresh_entries()
        self._invalidate()
        self._prefix_dev = None

    def _knn_sweep(self, searcher: MxuSearcher, u_dev: torch.Tensor, base: int, m: int,
                   C: int, n_total: int):
        """Pass A of the bulk paths: exact top-C (prefix metric, compact
        tier) of rows base..base+m of u_dev, self excluded."""
        knn_ids = np.empty((m, C), np.int32)
        knn_d = np.empty((m, C), np.float32)
        qb = 4096
        for start in range(0, m, qb):
            q = u_dev[base + start : base + min(start + qb, m)]
            d, ids = searcher.search(q, knbn=min(C + 1, n_total))
            me = np.arange(base + start, base + start + q.shape[0], dtype=np.int32)[:, None]
            d = np.where(ids == me, np.inf, d)  # drop self
            o = np.argsort(d, axis=1, kind="stable")[:, :C]
            knn_ids[start : start + q.shape[0]] = np.take_along_axis(ids, o, 1)
            knn_d[start : start + q.shape[0]] = np.take_along_axis(d, o, 1)
        return knn_ids, knn_d

    def _keep_rows(self, u_dev, knn_ids, knn_d, rows_all, rowsd_all, *, base, n_total,
                   m_near, sent) -> None:
        """Pass B of the bulk paths: heuristic keep on the device, forward
        rows on the host, written at rows base.. of rows_all."""
        m, C = knn_ids.shape
        kb = 1024 if m >= 1024 else _next_pow2(m, floor=16)
        for start in range(0, m, kb):
            b_real = min(kb, m - start)
            cid = np.zeros((kb, C), np.int32)
            cd = np.full((kb, C), np.inf, np.float32)
            cid[:b_real] = knn_ids[start : start + b_real]
            cd[:b_real] = knn_d[start : start + b_real]
            keep = _bulk_keep(u_dev, self._to_dev(cid), self._to_dev(cd)).cpu().numpy()
            rows_ids, rows_d = _forward_rows(
                cid, cd, keep, base=base + start, valid_limit=n_total,
                n_total=n_total, m0=self.m0, m_near=m_near, sent=sent,
                b_real=b_real)
            rows_all[base + start : base + start + b_real] = rows_ids[:b_real]
            rowsd_all[base + start : base + start + b_real] = rows_d[:b_real]

    def _timer(self, what: str):
        """tick(stage) records the seconds since the last tick in
        stats[what] (a device sync first, so device work is counted)."""
        times = self.stats[what] = {}
        last = [time.perf_counter()]

        def tick(stage):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
            times[stage] = now - last[0]
            log.info("%s %s: %.1fs", what, stage, now - last[0])
            last[0] = now
        return tick

    def _build_bulk(self, sigs: np.ndarray) -> None:
        """Bulk graph construction: A. exact top-C sweep (prefix metric,
        compact searcher); B. select-neighbors heuristic on the device +
        partitioned forward rows; C. one global host reverse merge."""
        tick = self._timer("build_s")
        n_total = sigs.shape[0]
        sp = self.search_prefix
        m0, mmax = self.m0, self.max_nb_conn
        sent = _next_pow2(n_total)
        rin = 8  # single global merge -> keep more incoming than per-batch
        m_near = max(m0 - max(m0 // 4, min(8, m0 // 2)), 4)
        C = min(max(min(2 * m0, 512), m0), max(n_total - 1, 1))
        # one host->device pass: the searcher and pass B both read it
        u_dev = self._to_dev(sig_bits(sigs[:, :sp]))
        tick("prefix to device")

        searcher = MxuSearcher(u_dev, self.device, compact=True,
                               nb_cand=min(3 * C, n_total))
        tick("searcher init")
        knn_ids, knn_d = self._knn_sweep(searcher, u_dev, 0, n_total, C, n_total)
        del searcher
        tick("pass A (exact top-C sweep)")

        rows_all = np.empty((n_total, m0), np.int32)
        rowsd_all = np.empty((n_total, m0), np.float32)
        self._keep_rows(u_dev, knn_ids, knn_d, rows_all, rowsd_all, base=0,
                        n_total=n_total, m_near=m_near, sent=sent)
        tick("pass B (keep + forward rows)")

        _global_reverse_merge(rows_all, rowsd_all, base_src=0, rin=rin,
                              mmax=mmax, m_near=m_near, sent=sent)
        tick("pass C (reverse merge)")
        self._rescue_orphans(rows_all, rowsd_all, rl=min(4, m0 - m_near))

        self._nbrs = np.where(rows_all >= n_total, _PAD, rows_all).astype(np.int32)
        self._nbr_d = np.where(rows_all >= n_total, np.inf,
                               rowsd_all).astype(np.float32)
        self._sigs = sigs
        self._refresh_entries()
        self._invalidate()
        self._prefix_dev = (n_total, u_dev, self._sigs_fp())
        tick("rescue + commit")

    def _rescue_orphans(self, rows_all: np.ndarray, rowsd_all: np.ndarray,
                        rl: int) -> None:
        """Guarantee in-degree >= 1 for every point after a merge pass: two
        rounds of forced back-links (orphan -> its nearest forward
        neighbor's tail slot), then pin what is still orphaned."""
        n_total, m0 = rows_all.shape
        if rl <= 0:
            return
        for _ in range(2):
            valid = (rows_all >= 0) & (rows_all < n_total)  # host pad is -1
            deg = np.bincount(rows_all[valid], minlength=n_total)
            orph = np.flatnonzero(deg == 0)
            if orph.size == 0:
                return
            t = rows_all[orph, 0]
            ok = (t >= 0) & (t < n_total)
            orph, t = orph[ok], t[ok]
            if orph.size == 0:
                break
            d = rowsd_all[orph, 0]
            srl = (orph ^ (orph >> 4) ^ (orph >> 9)) % rl
            tail_d = rowsd_all[t, m0 - rl:]
            order = np.argsort(-tail_d, axis=1, kind="stable")
            slot = order[np.arange(len(orph)), srl] + (m0 - rl)
            rows_all[t, slot] = orph
            rowsd_all[t, slot] = d
        valid = (rows_all >= 0) & (rows_all < n_total)
        deg = np.bincount(rows_all[valid], minlength=n_total)
        orph = np.flatnonzero(deg == 0).astype(np.int32)
        if orph.size:
            self._pinned = np.unique(np.concatenate([self._pinned, orph]))

    def _bulk_add(self, sigs: np.ndarray) -> None:
        """Bulk append into an existing graph: exact top-C sweep of the new
        batch against (existing + batch), heuristic links for the new rows,
        one global reverse merge into the existing near regions."""
        tick = self._timer("add_s")
        n0 = self.nb_points
        m = sigs.shape[0]
        n_total = n0 + m
        sp = self.search_prefix
        m0, mmax = self.m0, self.max_nb_conn
        sent = _next_pow2(n_total)
        rin = 8
        m_near = max(m0 - max(m0 // 4, min(8, m0 // 2)), 4)
        C = min(max(min(2 * m0, 512), m0), max(n_total - 1, 1))
        new_dev = self._to_dev(sig_bits(np.ascontiguousarray(sigs[:, :sp], self.sig_dtype)))
        # extend the resident prefix if there is one: only the NEW rows are uploaded
        old_dev = self._cached_prefix(n0)
        if old_dev is None:
            old_dev = self._to_dev(sig_bits(self._sigs[:, :sp]))
        u_dev = torch.cat([old_dev, new_dev], 0)
        del old_dev, new_dev
        self._prefix_dev = None  # stale from here until re-seeded below
        tick("prefix to device")

        searcher = MxuSearcher(u_dev, self.device, compact=True, nb_cand=min(3 * C, n_total))
        tick("searcher init")
        knn_ids, knn_d = self._knn_sweep(searcher, u_dev, n0, m, C, n_total)
        del searcher
        tick("pass A (exact top-C sweep)")

        # entry pinning (same rule as the beam-insert path)
        grow = np.arange(n0, n_total, dtype=np.int32)
        old_ok = (knn_ids < n0) & np.isfinite(knn_d)
        has_old = old_ok.any(axis=1)
        f_near = np.where(has_old,
                          np.take_along_axis(
                              knn_d, np.argmax(old_ok, 1)[:, None], 1)[:, 0],
                          np.inf)
        mate_lt = ((knn_ids >= n0) & (knn_ids < grow[:, None])
                   & (knn_d < self.PIN_D))
        new_pins = grow[(f_near >= self.PIN_D) & ~mate_lt.any(axis=1)]
        if new_pins.size:
            self._pinned = np.unique(
                np.concatenate([self._pinned, new_pins.astype(np.int32)]))

        self._ensure_nbr_d()
        rows_all = np.full((n_total, m0), sent, np.int32)
        rowsd_all = np.full((n_total, m0), np.inf, np.float32)
        rows_all[:n0] = np.where(self._nbrs == _PAD, sent, self._nbrs)
        rowsd_all[:n0] = self._nbr_d
        self._keep_rows(u_dev, knn_ids, knn_d, rows_all, rowsd_all, base=n0,
                        n_total=n_total, m_near=m_near, sent=sent)
        tick("pass B (keep + forward rows)")

        _global_reverse_merge(rows_all, rowsd_all, base_src=n0, rin=rin,
                              mmax=mmax, m_near=m_near, sent=sent)
        tick("pass C (reverse merge)")

        # reachability guarantee: each new point forces ONE back-link from a
        # near pre-existing neighbor into that row's tail slots
        rl = min(4, m0 - m_near)
        if rl > 0:
            cum = np.cumsum(old_ok, axis=1)
            k_old = cum[:, -1]
            has = k_old > 0
            pick = (grow % np.minimum(np.maximum(k_old, 1), 16)) + 1
            fcol = np.argmax(cum == pick[:, None], axis=1)
            rowsel = np.flatnonzero(has)
            if rowsel.size:
                f_tgt = knn_ids[rowsel, fcol[rowsel]]
                f_src = grow[rowsel]
                f_d = knn_d[rowsel, fcol[rowsel]]
                tail_d = rowsd_all[f_tgt, m0 - rl:]
                order = np.argsort(-tail_d, axis=1, kind="stable")
                srl = (f_src ^ (f_src >> 4) ^ (f_src >> 9)) % rl
                slot = order[np.arange(len(f_src)), srl]
                tail_i = rows_all[f_tgt, m0 - rl:]
                here = tail_i == f_src[:, None]
                slot = np.where(here.any(1), np.argmax(here, 1), slot) + (m0 - rl)
                rows_all[f_tgt, slot] = f_src
                rowsd_all[f_tgt, slot] = f_d
        self._rescue_orphans(rows_all, rowsd_all, rl)

        self._nbrs = np.where(rows_all >= n_total, _PAD, rows_all).astype(np.int32)
        self._nbr_d = np.where(rows_all >= n_total, np.inf,
                               rowsd_all).astype(np.float32)
        self._append_sigs(sigs)
        self._refresh_entries()
        self._invalidate()
        self._prefix_dev = (n_total, u_dev, self._sigs_fp())
        tick("rescue + commit")

    def _ensure_nbr_d(self) -> None:
        """Backfill cached link distances (prefix metric) for graphs loaded
        from dumps that predate the cache."""
        n = self.nb_points
        if self._nbr_d.shape[0] == n:
            return
        log.warning("recomputing %d cached link distances (old dump format)", n)
        sp = self.search_prefix
        sigs = sig_bits(self._sigs[:, :sp])
        out = np.full((n, self.m0), np.inf, np.float32)
        for s in range(0, n, 4096):
            e = min(n, s + 4096)
            ids = self._nbrs[s:e]
            ok = ids != _PAD
            rows = sigs[np.clip(ids, 0, n - 1)]
            eq = (rows == sigs[s:e, None, :]).sum(-1)
            d = 1.0 - eq / np.float32(sp)
            out[s:e] = np.where(ok, d, np.inf)
        self._nbr_d = out

    # ------------------------------------------------------------------ search

    def _device_arrays(self):
        if self._device is None:
            n = self.nb_points
            nb = _next_pow2(n)
            sp = self.search_prefix
            sigs_p = np.full((nb + 1, sp), -1, np.int32)
            sigs_p[:n] = sig_bits(self._sigs[:, :sp])
            nbrs_p = np.full((nb + 1, self.m0), nb, np.int32)
            nbrs_p[:n] = np.where(self._nbrs == _PAD, nb, self._nbrs)
            t = len(self._entry_ids)
            entries = np.full(_next_pow2(max(t, 16)), nb, np.int32)
            entries[:t] = self._entry_ids
            self._device = (self._to_dev(sigs_p), self._to_dev(nbrs_p), self._to_dev(entries))
        return self._device

    def _upload_rows(self, cols: int, fn=None) -> torch.Tensor:
        """The first `cols` slots of every signature as int32 rows on the
        device, optionally transformed per 8192-row chunk by fn."""
        n = self.nb_points
        out = None
        for start in range(0, n, 8192):
            rows = self._to_dev(sig_bits(self._sigs[start : start + 8192, :cols]))
            rows = fn(rows) if fn is not None else rows
            if out is None:
                out = torch.empty((n, rows.shape[1]), dtype=torch.int32, device=self.device)
            out[start : start + rows.shape[0]] = rows
        return out

    def _device_packed_sigs(self, w: int, bits: int = 16) -> torch.Tensor:
        """Hashed-slot rerank tier over the first w slots: [n, w*bits/32]
        int32 lanes of packed `bits`-bit slot hashes (column pads 0).  The
        previous tier is freed first."""
        if (self._device_packed is not None
                and self._device_packed[:2] == (w, bits)):
            return self._device_packed[2]
        self._device_packed = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        pack = _PACKERS[bits]
        buf = self._upload_rows(min(w, self.sketch_size),
                                lambda rows: pack(rows, spad=w, pad_val=0))
        self._device_packed = (w, bits, buf)
        return buf

    def _device_full_sigs(self) -> torch.Tensor:
        """Full signatures on the device, [n, S] int32."""
        if self._device_full is None:
            self._device_full = self._upload_rows(self.sketch_size)
        return self._device_full

    def _coarse_searcher(self):
        """MxuSearcher over the signature PREFIX, or None when even the
        estimator-only form exceeds COARSE_BYTES."""
        if self._coarse is False:
            return None
        if self._coarse is None:
            sp = self.search_prefix
            n = self.nb_points
            # consume (don't keep: the rerank tier needs the memory) the
            # prefix left on the device by a bulk build/add
            src = self._cached_prefix(n)
            self._prefix_dev = None
            if src is None:
                src = np.ascontiguousarray(sig_bits(self._sigs[:, :sp]))

            _, rep = planned_footprint(n, sp)
            if rep > self.COARSE_BYTES:
                if sp >= self.sketch_size:
                    # no_rerank configs take the coarse output as FINAL
                    # distances: the estimator must never be terminal
                    self._coarse = False
                    return None
                # estimator-only pool (sign expansion alone) whose top-r is
                # the candidate pool; the rerank tier does the ranking
                nb = _next_pow2(n)
                m_est = next((m for m in (4, 2, 1)
                              if nb * m * sp <= self.COARSE_BYTES), 0)
                if not m_est:
                    self._coarse = False
                    return None
                self._coarse = MxuSearcher(src, self.device, m=m_est, compact=False,
                                           estimator_only=True)
                return self._coarse
            # explicit candidate width: 2048 estimator candidates feed the
            # exact-prefix top-r for any r <= 1024
            self._coarse = MxuSearcher(src, self.device, nb_cand=2048)
        return self._coarse

    def search(
        self, queries: np.ndarray, knbn: int, ef_search: int = 0
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched k-NN: candidates on the signature prefix (coarse sweep on
        CUDA at scale, else entry tier + beam) -> rerank tier.  Returns
        (distances [Q, k], ids [Q, k])."""
        trace.count("search.queries", queries.shape[0])
        with trace.span("search"):
            return self._search(queries, knbn, ef_search)

    def _search(self, queries: np.ndarray, knbn: int, ef_search: int):
        n = self.nb_points
        nq = queries.shape[0]
        if n == 0:
            return np.full((nq, 0), np.inf, np.float32), np.zeros((nq, 0), np.int32)
        knbn = min(knbn, n)
        queries = np.ascontiguousarray(queries, dtype=self.sig_dtype)

        if n <= 2048 or len(self._entry_ids) >= n:
            # tiny database: the entry tier is the whole database (K1)
            self.stats["search"] = {"route": "exact"}
            return bucketed_knn(self._stager.rows(queries),
                                as_int32_rows(self._sigs).to(self.device), knbn)

        dev = self.device
        # pad rows all-ones bits as in the reference
        q_dev = self._stager.rows(queries, _next_pow2(nq, floor=8))
        tier_kind = self._rerank_tier()[0]
        need_host_rerank = self.search_prefix < self.sketch_size and tier_kind == "host"
        # packed4's hash noise can swap ranks near the k-th answer:
        # over-fetch and let the exact host re-score pick the true top-k
        fetch = min(max(32, knbn), n) if tier_kind == "packed4" else knbn
        d, ids = self.search_device(q_dev, fetch, ef_search, rerank=not need_host_rerank)
        if not need_host_rerank and tier_kind == "full":
            with trace.span("search.download", dev):
                return d.cpu().numpy()[:nq], ids.cpu().numpy()[:nq]
        with trace.span("search.download", dev):
            ids_h = ids.cpu().numpy()[:nq]
        trace.count("search.rescore_rows", ids_h.size)
        with trace.span("search.rescore"):
            if not need_host_rerank:
                # the packed tiers' distances are hash-collision-inflated: the
                # answers re-score exactly from the host signatures
                dx = self._host_distances(queries, ids_h)
                sel = np.argsort(dx, axis=1, kind="stable")[:, :knbn]
                return (np.take_along_axis(dx, sel, axis=1),
                        np.take_along_axis(ids_h, sel, axis=1))

            # host rerank: no device tier fits; candidates at prefix precision
            d = self._host_distances(queries, ids_h)
            sel = np.argpartition(d, knbn - 1, axis=1)[:, :knbn]
            dsel = np.take_along_axis(d, sel, axis=1)
            o = np.argsort(dsel, axis=1, kind="stable")
            return (
                np.take_along_axis(dsel, o, axis=1),
                np.take_along_axis(np.take_along_axis(ids_h, sel, axis=1), o, axis=1),
            )

    def _host_distances(self, queries: np.ndarray, ids_h: np.ndarray) -> np.ndarray:
        """Exact distances of queries [Q, S] to the rows ids_h [Q, R] from
        the host signatures, +inf past n: the equal-slot counts from the
        native gather-and-count (`ops/host_rescore.py`), or where it is not
        built the reference's numpy form; the same counts either way."""
        n = self.nb_points
        eq = host_rescore.eq_counts(self._sigs, queries, ids_h)
        trace.count("search.rescore_native_rows", 0 if eq is None else ids_h.size)
        if eq is None:
            rows = sig_bits(self._sigs[np.clip(ids_h, 0, n - 1)])  # [Q, R, S] bits, u16 widened
            eq = (rows == sig_bits(queries)[:, None, :]).sum(-1)
        d = (1.0 - eq / np.float32(self.sketch_size)).astype(np.float32)
        d[ids_h >= n] = np.inf
        return d

    def _rerank_tier(self) -> tuple:
        """(kind, width): which device rerank tier fits the budget at this
        N x S — the reference's rule on its padded layout: "full" (exact),
        "packed" (16-bit hashes over the first w slots), "packed8" and
        "packed4" (8- and 4-bit hashes over all slots), or "host"."""
        n = self.nb_points
        sp = self.search_prefix
        nbp1 = _next_pow2(n) + 1
        full_bytes = nbp1 * _round_up(self.sketch_size, 1024) * 4
        if full_bytes <= _RERANK_DEVICE_BYTES:
            return "full", self.sketch_size
        budget = int(0.7 * _RERANK_DEVICE_BYTES)
        w16 = min(budget // (2 * nbp1) // 2048 * 2048,
                  _round_up(self.sketch_size, 2048))
        if w16 >= _round_up(self.sketch_size, 2048):
            return "packed", w16          # full-width 16-bit
        w8 = _round_up(self.sketch_size, 4096)
        if budget // nbp1 >= w8:
            return "packed8", w8          # full-width 8-bit
        w4 = _round_up(self.sketch_size, 8192)
        if budget // nbp1 >= w4 // 2:
            return "packed4", w4          # full-width 4-bit, host polish
        if w16 >= 2048 and w16 > sp:
            return "packed", w16          # sampled 16-bit (last resort)
        return "host", 0

    def search_device(self, q_dev: torch.Tensor, knbn: int, ef_search: int = 0,
                      rerank: bool = True):
        """Device-resident search: q_dev [Qb, S] int32 on the device.
        Returns device tensors (distances [Qb, k], ids [Qb, k]); with
        rerank=False the candidates at prefix precision."""
        n = self.nb_points
        nb = _next_pow2(n)
        sp = self.search_prefix
        q_p = q_dev[:, :sp].contiguous()

        ef = max(ef_search or self.DEFAULT_EF, knbn)
        ef_round = _round_up(min(ef, nb), 64)
        expand = self.EXPAND
        hops = max(8, int(2 * math.log2(nb)) + ef_round // expand)
        no_rerank = sp >= self.sketch_size
        r = knbn if no_rerank else min(_round_up(max(4 * knbn, 32), 8), ef_round)

        stats = self.stats["search"] = {}
        coarse = None
        if self.device.type == "cuda" and n >= self.COARSE_MIN:
            coarse = self._coarse_searcher()
        if coarse is not None:
            if not no_rerank:
                # the coarse sweep's candidates are the exact prefix-metric
                # top-r, not bounded by ef; capped inside nb_cand=2048
                r = min(_round_up(max(16 * knbn, 160), 8), nb, 1024)
            stats["route"] = "coarse"
            with trace.span("search.route.coarse", self.device):
                dp, ids = coarse.search_device(q_p, knbn=knbn if no_rerank else r)
                if not no_rerank and rerank:
                    # candidates in id order: the rerank's stable top-k then
                    # orders distance ties by id, as both flat routes do
                    ids, _ = torch.sort(ids, dim=1)
        else:
            stats["route"] = "beam"
            with trace.span("search.route.beam", self.device):
                sigs_p, nbrs_p, entries = self._device_arrays()
                dp, ids = _graph_search(sigs_p, nbrs_p, entries, q_p, n, ef=ef_round, r=r,
                                        hops=hops, expand=expand, stats=stats)
        if no_rerank or not rerank:
            return dp, ids

        kind, w = self._rerank_tier()
        stats["tier"] = kind
        if kind not in ("full", "packed", "packed8", "packed4"):
            raise ValueError("no device rerank tier fits; use search() (host rerank)")
        with trace.span("search.rerank", self.device):
            if kind == "full":
                return _rerank_device(self._device_full_sigs(), q_dev, ids, n,
                                      knbn=knbn, s_true=self.sketch_size)
            bits = {"packed": 16, "packed8": 8, "packed4": 4}[kind]
            wq = min(w, self.sketch_size)
            packed = self._device_packed_sigs(w, bits=bits)
            q_pk = _PACKERS[bits](q_dev[:, :wq], spad=w, pad_val=1)
            return _rerank_device(packed, q_pk, ids, n, knbn=knbn, s_true=wq,
                                  parts=32 // bits)

    # ------------------------------------------------------------------ io

    def save_arrays(self, prefix: str) -> dict:
        save_sigs(prefix, self._sigs)
        self._ensure_nbr_d()
        np.savez(
            prefix + ".graph.npz",
            nbrs=self._nbrs,
            nbr_d=self._nbr_d,
            entry_ids=self._entry_ids,
            pinned=self._pinned,
        )
        return {
            "max_nb_conn": self.max_nb_conn,
            "ef_construction": self.ef_construction,
            "scale_modification": self.scale_modification,
            "search_prefix": self.search_prefix,
        }

    @classmethod
    def load_arrays(cls, prefix: str, meta: dict, device: torch.device) -> "HnswIndex":
        buf, n = load_sigs(prefix, headroom=True)
        g = np.load(prefix + ".graph.npz")
        idx = cls(
            sketch_size=buf.shape[1],
            sig_dtype=buf.dtype,
            max_nb_conn=int(meta.get("max_nb_conn", 64)),
            ef_construction=int(meta.get("ef_construction", 200)),
            scale_modification=float(meta.get("scale_modification", 1.0)),
            search_prefix=int(meta.get("search_prefix", 1024)),
            device=device,
        )
        idx.adopt_sig_buffer(buf, n)
        idx._nbrs = g["nbrs"]
        if "nbr_d" in g:
            idx._nbr_d = g["nbr_d"]
        idx._entry_ids = g["entry_ids"]
        if "pinned" in g:
            idx._pinned = g["pinned"]
        return idx

    @classmethod
    def from_jax(cls, jax_index, *, device: torch.device) -> "HnswIndex":
        """Carry a gsearch_tpu HnswIndex across onto `device`: its
        signatures, graph, cached link distances, entry tier, pins and
        parameters, as numpy."""
        idx = cls(
            sketch_size=jax_index.sketch_size,
            sig_dtype=jax_index.sig_dtype,
            max_nb_conn=jax_index.max_nb_conn,
            ef_construction=jax_index.ef_construction,
            scale_modification=jax_index.scale_modification,
            search_prefix=jax_index.search_prefix,
            device=device,
        )
        idx._sigs = np.array(jax_index._sigs, dtype=idx.sig_dtype)
        idx._nbrs = np.array(jax_index._nbrs, dtype=np.int32)
        idx._nbr_d = np.array(jax_index._nbr_d, dtype=np.float32)
        idx._entry_ids = np.array(jax_index._entry_ids, dtype=np.int32)
        idx._pinned = np.array(jax_index._pinned, dtype=np.int32)
        idx.entry_tier_mult = float(jax_index.entry_tier_mult)
        return idx
