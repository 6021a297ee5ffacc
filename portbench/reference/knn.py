"""Exact k-NN of sketch signatures by equal-slot count, in plain torch.

The distance of two signatures of S slots is 1 - eq / S, eq the number of
slots whose 32-bit values are equal.  `ExactKnn` keeps the database as
int32 bit patterns on a device and sweeps every row for each query, in
blocks that bound the [queries, rows, S] compare buffer.  `hashed=8`
compares 8-bit hashes of the slots instead of the slots: the control,
one precision step below the 16-bit slot hashes that the compact search
tier reranks on, and two below the exact slots.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def _hash8(bits: torch.Tensor) -> torch.Tensor:
    """Top 8 bits of a multiplicative hash of each u32 slot, as uint8."""
    x = bits.to(torch.int64) & M32
    c = 0x9E3779B1
    x = ((((x * (c >> 16)) & 0xFFFF) << 16) + x * (c & 0xFFFF)) & M32
    return (x >> 24).to(torch.uint8)


class ExactKnn:
    def __init__(self, db: np.ndarray, device, *, hashed: int = 0, buffer_bytes: int | None = None):
        """db [N, S] host signatures (f32 or int32 bits)."""
        if hashed not in (0, 8):
            raise ValueError("hashed must be 0 (exact) or 8")
        self.device = torch.device(device)
        self.n, self.s = db.shape
        self.hashed = hashed
        self.buffer_bytes = buffer_bytes or ((1 << 31) if self.device.type == "cuda" else (1 << 26))
        bits = db.view(np.int32)
        rows = []
        for start in range(0, self.n, 16384):
            part = torch.from_numpy(np.ascontiguousarray(bits[start : start + 16384])).to(self.device)
            rows.append(_hash8(part) if hashed else part)
        self.db = torch.cat(rows)

    def _form(self, q: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(q.view(np.int32))).to(self.device)
        return _hash8(t) if self.hashed else t

    def _blocks(self, nq: int):
        per_q = max(1, self.buffer_bytes // (self.s * 16384))
        qc = min(nq, per_q)
        nc = max(1, min(self.n, self.buffer_bytes // (self.s * qc)))
        return qc, nc

    def top(self, queries: np.ndarray, k: int):
        """(eq [Q, k] int64 descending, ids [Q, k] int64): the k rows with
        the most equal slots, ties by lower id."""
        q = self._form(queries)
        qc, nc = self._blocks(q.shape[0])
        out_eq, out_ids = [], []
        for q0 in range(0, q.shape[0], qc):
            qb = q[q0 : q0 + qc]
            eq = torch.empty((qb.shape[0], self.n), dtype=torch.int32, device=self.device)
            for n0 in range(0, self.n, nc):
                block = self.db[n0 : n0 + nc]
                eq[:, n0 : n0 + block.shape[0]] = (block[None] == qb[:, None]).sum(-1, dtype=torch.int32)
            # (eq desc, id asc) through one stable sort of -eq
            order = torch.sort(-eq, dim=1, stable=True).indices[:, :k]
            out_eq.append(eq.gather(1, order).to(torch.int64))
            out_ids.append(order)
        return torch.cat(out_eq).cpu().numpy(), torch.cat(out_ids).cpu().numpy()

    def eq_of(self, queries: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Equal-slot counts [Q, R] of each query to the rows ids [Q, R]
        (ids must lie in [0, N))."""
        q = self._form(queries)
        idx = torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int64)).to(self.device)
        out = []
        step = max(1, self.buffer_bytes // (self.s * max(1, ids.shape[1]) * 4))
        for q0 in range(0, q.shape[0], step):
            rows = self.db[idx[q0 : q0 + step]]  # [qb, R, S]
            out.append((rows == q[q0 : q0 + step, None]).sum(-1))
        return torch.cat(out).cpu().numpy().astype(np.int64)

    def search(self, queries: np.ndarray, k: int):
        """(distances [Q, k] f32, ids [Q, k] int32), as a search returns them."""
        eq, ids = self.top(queries, k)
        d = (1.0 - eq.astype(np.float64) / self.s).astype(np.float32)
        return d, ids.astype(np.int32)
