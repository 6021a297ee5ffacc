"""Sign-expansion search: slot equality estimated by an int8 matmul, then
an exact rerank of the candidates.

Counterpart of the full-width tier of gsearch_tpu/ops/mxu.py (m = 4 sign
bits per slot, `rerank_factor` = 8, nb_cand = max(8k, 64)).  Every slot
value is hashed and expanded into m signs; equal slots agree on all m,
unequal ones on m/2 on average, so the int8 dot product of two expansions
is an unbiased Jaccard estimate.  Search = `torch._int_mm` scores ->
exact top-C candidates -> rerank through K2 (`gather_hamming`) -> top-k.
Rerank distances are the exact 1 - eq/S values.

Candidate selection is an exact top-k ordered as `jax.lax.top_k` orders it
(score descending, ties by lower id), not the reference's TPU-only
`approx_max_k`.  Results are ordered by (distance, id), the order of the
exact sweep, so both routes of the flat index write the same neighbours
file; the reference orders distance ties by candidate score instead.  The compact, packed8 and packed4 tiers, the
estimator-only searcher and the TPU layout/chunking rules are not ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import cuda_lib
from .distance import as_int32_rows, gather_hamming, topk_smallest
from .hash import M32, as_u32, mix32

_EXPAND_SEED = 0x51614B17

# rows per expansion chunk: bounds the int64 hash temporaries of the build
_EXPAND_ROWS = 1024
# bound on one query chunk's [Qc, N] score matrix (elements)
_SCORE_ELEMS = 1 << 26
# device memory kept free beside the two representations (score buffers,
# top-k and expansion temporaries)
_HEADROOM_BYTES = 2 << 30


def expand_signs(sigs: torch.Tensor, m: int = 4) -> torch.Tensor:
    """[N, S] signatures (f32 or int32) -> [N, m*S] int8 in {-1, +1}."""
    h = mix32(as_u32(sigs), _EXPAND_SEED)
    n, s = sigs.shape
    out = torch.empty((n, s, m), dtype=torch.int8, device=sigs.device)
    for b in range(m):
        out[:, :, b] = (((h >> b) & 1) * 2 - 1).to(torch.int8)
    return out.reshape(n, s * m)


def _round8(x: int) -> int:
    return (x + 7) // 8 * 8


class MxuSearcher:
    """Holds the sign expansion and the rerank matrix on the device."""

    def __init__(self, sigs: np.ndarray, device: torch.device, m: int = 4,
                 rerank_factor: int = 8):
        rows = as_int32_rows(sigs)
        self.n, self.s = rows.shape
        self.m = m
        self.rerank_factor = rerank_factor
        self.device = device
        # _int_mm on CUDA wants the inner width and the column count in
        # multiples of 8: zero columns/rows add nothing to a dot product,
        # and scores of pad rows are sliced off before selection
        self._k = _round8(m * self.s)
        n8 = _round8(self.n)
        need = n8 * self._k + self.n * self.s * 4
        if device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(device)
            if need + _HEADROOM_BYTES > free:
                raise MemoryError(
                    f"full-width MxuSearcher for {self.n} x {self.s} needs {need} bytes "
                    f"(+{_HEADROOM_BYTES} headroom) but {free} are free on {device}; "
                    "the compact/packed tiers that fit larger databases are not ported "
                    "yet (ROADMAP.md)")
        # the rerank matrix IS the signature bits: no separate source copy
        self._rr = torch.empty((self.n, self.s), dtype=torch.int32, device=device)
        self._db_exp = torch.zeros((n8, self._k), dtype=torch.int8, device=device)
        for start in range(0, self.n, _EXPAND_ROWS):
            chunk = rows[start : start + _EXPAND_ROWS].to(device)
            self._rr[start : start + chunk.shape[0]] = chunk
            self._db_exp[start : start + chunk.shape[0], : m * self.s] = expand_signs(chunk, m)

    def _candidates(self, q: torch.Tensor, nb_cand: int) -> torch.Tensor:
        """Top-nb_cand rows by sign-dot score, as top_k orders them."""
        rows = q.shape[0]
        qp = max(32, _round8(rows))  # _int_mm on CUDA needs more than 16 rows
        q_exp = torch.zeros((qp, self._k), dtype=torch.int8, device=self.device)
        q_exp[:rows, : self.m * self.s] = expand_signs(q, self.m)
        scores = torch._int_mm(q_exp, self._db_exp.t())[:rows, : self.n]
        cuda_lib.launches["int_mm"] += 1
        # (score desc, id asc) as one distinct int64 key: |score| <= m*S
        ids = torch.arange(self.n, dtype=torch.int64, device=self.device)
        key = scores.to(torch.int64) * (1 << 32) + (M32 - ids)
        return torch.topk(key, nb_cand, dim=1, sorted=True).indices

    def search(self, queries: np.ndarray, knbn: int) -> Tuple[np.ndarray, np.ndarray]:
        """queries [Q, S] -> (distances [Q, k], ids [Q, k])."""
        q = as_int32_rows(queries).to(self.device)
        knbn = min(knbn, self.n)
        nb_cand = min(max(self.rerank_factor * knbn, 64), self.n)
        chunk = max(32, _SCORE_ELEMS // _round8(self.n))
        dists = [torch.empty((0, knbn), dtype=torch.float32, device=self.device)]
        ids = [torch.empty((0, knbn), dtype=torch.int64, device=self.device)]
        for start in range(0, q.shape[0], chunk):
            qc = q[start : start + chunk]
            # candidates in id order, so the stable top-k breaks distance
            # ties by lower id exactly as the exact sweep (bucketed_knn) does
            cand, _ = torch.sort(self._candidates(qc, nb_cand), dim=1)
            d = gather_hamming(self._rr, qc, cand.to(torch.int32))
            dist, sel = topk_smallest(d, knbn)
            dists.append(dist)
            ids.append(cand.gather(1, sel))
        return (torch.cat(dists).cpu().numpy(),
                torch.cat(ids).to(torch.int32).cpu().numpy())
