"""Sign-expansion search: slot equality estimated by an int8 matmul, then
an exact rerank of the candidates.

Counterpart of gsearch_tpu/ops/mxu.py.  Every slot value is hashed and
expanded into m signs; equal slots agree on all m, unequal ones on m/2 on
average, so the int8 dot product of two expansions is an unbiased Jaccard
estimate.  Search = `torch._int_mm` scores -> exact top-C candidates ->
rerank through K2 (`gather_hamming`) -> top-k.

Three tiers, chosen by the reference's rule (`planned_footprint`,
`MxuSearcher._resolve_mode`), so both packages build the same tier for the
same (n, S):
  - full width: m = 4, rerank on the raw slots (exact 1 - eq/S);
  - compact, once nb * (m*S + 4*spad) exceeds COMPACT_BYTES: m = 2, rerank
    on 16-bit slot hashes packed in pairs (`pack_hash16`, K2 `parts=2`),
    candidate list doubled;
  - estimator-only: the sign expansion alone, whose top-k by score is a
    candidate pool for a caller that reranks with its own tier (the graph
    index's coarse route); distances are the estimate 1 - score/(m*S).
`pack_hash8` and `pack_hash4` are the graph index's 8- and 4-bit tiers.

Candidate selection is an exact top-k ordered as `jax.lax.top_k` orders it
(score descending, ties by lower id), not the reference's TPU-only
`approx_max_k`.  Reranked results are ordered by (distance, id), the order
of the exact sweep, so both routes of the flat index write the same
neighbours file; the reference orders distance ties by candidate score
instead.  The TPU layout and chunking rules are not ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils import trace
from . import cuda_lib
from .distance import _as_i32, _distance, as_int32_rows, gather_hamming, topk_smallest
from .hash import M32, as_u32, mix32
from .query_stage import QueryStager

_EXPAND_SEED = 0x51614B17
_RERANK_SEED = 0x243F6A88  # independent of the expansion hash

# rows per expansion chunk: bounds the int64 hash temporaries of the build
_EXPAND_ROWS = 1024
# bound on one query chunk's [Qc, N] score matrix (elements)
_SCORE_ELEMS = 1 << 26
# bound on one rerank launch's [Q, nb_cand] candidate ids (elements)
_RERANK_ELEMS = 1 << 23
# device memory kept free beside the representations (score buffers,
# top-k and expansion temporaries)
_HEADROOM_BYTES = 2 << 30


def expand_signs(sigs: torch.Tensor, m: int = 4) -> torch.Tensor:
    """[N, S] signatures (f32 by bit pattern, or int32 bits) -> [N, m*S]
    int8 in {-1, +1}."""
    h = mix32(as_u32(sigs), _EXPAND_SEED)
    n, s = sigs.shape
    out = torch.empty((n, s, m), dtype=torch.int8, device=sigs.device)
    for b in range(m):
        out[:, :, b] = (((h >> b) & 1) * 2 - 1).to(torch.int8)
    return out.reshape(n, s * m)


def _to_i32(u: torch.Tensor) -> torch.Tensor:
    """u32 carrier (int64 in [0, 2^32)) -> int32 with the same bits."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def _pack_hash(rows: torch.Tensor, bits: int, spad: int, pad_val: int) -> torch.Tensor:
    r, s = rows.shape
    if spad < s or spad % (32 // bits):
        raise ValueError(f"spad={spad} must cover S={s} and hold whole lanes")
    h = mix32(as_u32(rows), _RERANK_SEED) >> (32 - bits)  # [R, S] in [0, 2^bits)
    if spad > s:
        h = torch.cat([h, torch.full((r, spad - s), pad_val, dtype=h.dtype, device=h.device)], 1)
    parts = 32 // bits
    packed = h[:, 0::parts]
    for b in range(1, parts):
        packed = packed | (h[:, b::parts] << (bits * b))
    return _to_i32(packed)


def pack_hash16(rows: torch.Tensor, *, spad: int, pad_val: int) -> torch.Tensor:
    """[R, S] signatures -> [R, spad/2] int32 lanes: 16-bit slot hashes
    packed in pairs (slot 2i in the low half).  Column pads (spad > S) take
    pad_val in every field: 0 for the database, 1 for queries, so a padded
    field never counts equal.  Bit-exact with gsearch_tpu's _pack_hash16
    reshaped to [R, spad/2]."""
    return _pack_hash(rows, 16, spad, pad_val)


def pack_hash8(rows: torch.Tensor, *, spad: int, pad_val: int) -> torch.Tensor:
    """[R, S] -> [R, spad/4] int32: 8-bit slot hashes packed in fours."""
    return _pack_hash(rows, 8, spad, pad_val)


def pack_hash4(rows: torch.Tensor, *, spad: int, pad_val: int) -> torch.Tensor:
    """[R, S] -> [R, spad/8] int32: 4-bit slot hashes packed in eights."""
    return _pack_hash(rows, 4, spad, pad_val)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _next_pow2(n: int, floor: int = 16) -> int:
    nb = floor
    while nb < n:
        nb <<= 1
    return nb


def planned_footprint(n: int, s: int, m: int = 4) -> Tuple[bool, int]:
    """(compact?, bytes) of the tier the reference's constructor chooses for
    [n, s] signatures (gsearch_tpu/ops/mxu.py:320-331, the same rule)."""
    nb = _next_pow2(n)
    full = nb * (m * s + 4 * _round_up(s, 1024))
    if full <= MxuSearcher.COMPACT_BYTES:
        return False, full
    return True, nb * (2 * s + 2 * _round_up(s, 2048))


class MxuSearcher:
    """Holds the sign expansion and the rerank matrix on the device."""

    # switch to the compact tier when the full-width representations of the
    # reference's padded layout would exceed this many bytes
    COMPACT_BYTES = 8_000_000_000

    def __init__(self, sigs, device: torch.device, m: int = 4, rerank_factor: int = 8,
                 compact: bool | None = None, nb_cand: int | None = None,
                 estimator_only: bool = False):
        """sigs: [N, S] host numpy (f32, i32, u32, or u16 widened by value)
        or a torch tensor of those types (e.g. already on the device)."""
        rows = as_int32_rows(sigs) if isinstance(sigs, np.ndarray) else _as_i32(sigs, "MxuSearcher")
        self.n, self.s = rows.shape
        self.device = device
        self.rerank_factor = rerank_factor
        self.nb_cand_override = nb_cand
        self.estimator_only = bool(estimator_only)
        self._stager = QueryStager(device)  # query batches to the device
        self._spad, self.m = self._resolve_mode(m, compact)
        m = self.m
        # _int_mm on CUDA wants the inner width and the column count in
        # multiples of 8: zero columns/rows add nothing to a dot product,
        # and scores of pad rows are sliced off before selection
        self._k = _round_up(m * self.s, 8)
        n8 = _round_up(self.n, 8)
        lanes = 0 if self.estimator_only else (self._spad // 2 if self.compact else self.s)
        need = n8 * self._k + self.n * lanes * 4
        if device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(device)
            if need + _HEADROOM_BYTES > free:
                tier = ("estimator-only" if self.estimator_only
                        else "compact" if self.compact else "full-width")
                raise MemoryError(
                    f"{tier} MxuSearcher for {self.n} x {self.s} needs {need} bytes "
                    f"(+{_HEADROOM_BYTES} headroom) but {free} are free on {device}")
        # the full-width rerank matrix IS the signature bits: no source copy
        self._rr = None if lanes == 0 else torch.empty(
            (self.n, lanes), dtype=torch.int32, device=device)
        self._db_exp = torch.zeros((n8, self._k), dtype=torch.int8, device=device)
        for start in range(0, self.n, _EXPAND_ROWS):
            chunk = rows[start : start + _EXPAND_ROWS].to(device)
            stop = start + chunk.shape[0]
            self._db_exp[start:stop, : m * self.s] = expand_signs(chunk, m)
            if self._rr is not None:
                self._rr[start:stop] = (pack_hash16(chunk, spad=self._spad, pad_val=0)
                                        if self.compact else chunk)

    def _resolve_mode(self, m: int, compact: bool | None):
        """(column pad, expansion width), setting self.compact: the
        reference's rule (gsearch_tpu/ops/mxu.py:378-394)."""
        if compact is None:
            compact = planned_footprint(self.n, self.s, m)[0]
        self.compact = bool(compact)
        if self.compact and m == 4:
            m = 2  # compact default: half-width expansion
        # packed pairs: the reference keeps spad/2 lanes a multiple of 1024
        return _round_up(self.s, 2048 if self.compact else 1024), m

    def _top_scores(self, q: torch.Tensor, k: int):
        """Top-k rows by sign-dot score, as top_k orders them: (ids int64,
        scores int64), score descending, ties by lower id."""
        rows, dev = q.shape[0], self.device
        qp = max(32, _round_up(rows, 8))  # _int_mm on CUDA needs more than 16 rows
        with trace.span("search.expand", dev):
            q_exp = torch.zeros((qp, self._k), dtype=torch.int8, device=dev)
            q_exp[:rows, : self.m * self.s] = expand_signs(q, self.m)
        with trace.span("search.int_mm", dev):
            scores = torch._int_mm(q_exp, self._db_exp.t())[:rows, : self.n]
        cuda_lib.launches["int_mm"] += 1
        with trace.span("search.select", dev):
            # (score desc, id asc) as one distinct int64 key: |score| <= m*S
            ids = torch.arange(self.n, dtype=torch.int64, device=dev)
            key = scores.to(torch.int64) * (1 << 32) + (M32 - ids)
            top = torch.topk(key, k, dim=1, sorted=True)
        return top.indices, top.values >> 32

    def _nb_cand(self, knbn: int) -> int:
        if self.nb_cand_override:
            return min(max(self.nb_cand_override, knbn), self.n)
        nb_cand = min(max(self.rerank_factor * knbn, 64), self.n)
        if self.compact:
            # m=2 halves the estimator's sign bits: double the rerank list
            nb_cand = min(max(2 * nb_cand, 128), self.n)
        return nb_cand

    def search_device(self, q: torch.Tensor, knbn: int):
        """q [Q, S] f32 or int32 on the searcher's device -> (distances
        [Q, k] f32, ids [Q, k] int32), both on the device.  Scores and
        candidates are taken in chunks of _SCORE_ELEMS; the candidates of
        the chunks are reranked by one K2 launch and one top-k over the
        batch, up to _RERANK_ELEMS candidate ids a launch (each query's
        distances and top-k are independent of the chunking)."""
        with trace.span("search.device", self.device):
            q = _as_i32(q, "MxuSearcher.search")
            knbn = min(knbn, self.n)
            chunk = max(32, _SCORE_ELEMS // _round_up(self.n, 8))
            dev = self.device
            dists = [torch.empty((0, knbn), dtype=torch.float32, device=dev)]
            ids = [torch.empty((0, knbn), dtype=torch.int32, device=dev)]
            if self.estimator_only:
                for start in range(0, q.shape[0], chunk):
                    # the pool itself: top-k by score, estimated distances
                    top, score = self._top_scores(q[start : start + chunk], knbn)
                    with trace.span("search.final", dev):
                        dists.append(_distance(score, self.m * self.s))
                        ids.append(top.to(torch.int32))
                return torch.cat(dists), torch.cat(ids)
            nb_cand = self._nb_cand(knbn)
            batch = max(chunk, _RERANK_ELEMS // nb_cand // chunk * chunk)
            for b0 in range(0, q.shape[0], batch):
                qb = q[b0 : b0 + batch]
                # candidates in id order, so the stable top-k breaks distance
                # ties by lower id exactly as the exact sweep (bucketed_knn) does
                tops = []
                for start in range(0, qb.shape[0], chunk):
                    top = self._top_scores(qb[start : start + chunk], nb_cand)[0]
                    with trace.span("search.select", dev):
                        tops.append(torch.sort(top, dim=1)[0])
                cand = torch.cat(tops).to(torch.int32)
                trace.count("search.candidates", qb.shape[0] * nb_cand)
                with trace.span("search.rerank", dev):
                    if self.compact:
                        d = gather_hamming(self._rr, pack_hash16(qb, spad=self._spad, pad_val=1),
                                           cand, parts=2, s_true=self.s)
                    else:
                        d = gather_hamming(self._rr, qb, cand)
                with trace.span("search.final", dev):
                    dist, sel = topk_smallest(d, knbn)
                    dists.append(dist)
                    ids.append(cand.gather(1, sel))
            return torch.cat(dists), torch.cat(ids)

    def search(self, queries, knbn: int) -> Tuple[np.ndarray, np.ndarray]:
        """queries [Q, S] (numpy, or a tensor on the device) -> numpy
        (distances [Q, k], ids [Q, k])."""
        if isinstance(queries, np.ndarray):
            queries = self._stager.rows(queries)
        d, ids = self.search_device(queries, knbn)
        with trace.span("search.download", self.device):
            return d.cpu().numpy(), ids.cpu().numpy()
