"""Flat (exact) sketch index.

Counterpart of gsearch_tpu/index/flat.py.  Signatures are kept on the host
and uploaded at first search.  Routes: on a CUDA device with at least
MXU_MIN_POINTS points the sign-expansion searcher (ops/mxu.py: int8
matmul candidates, rerank through K2), in the tier the reference's rule
picks for (N, S): full width (exact distances) up to 65,536 genomes at
S = 12,000, compact (16-bit hashed rerank) above; otherwise the exact
sweep through K1 (`bucketed_knn`).  The reference takes the first route where
JAX's default backend is a TPU.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.distance import as_int32_rows, bucketed_knn
from ..ops.mxu import MxuSearcher
from ..utils import trace
from .sigfile import load_sigs, save_sigs


class FlatIndex:
    KIND = "flat"
    # databases at least this large search through MxuSearcher on CUDA
    MXU_MIN_POINTS = 4096

    def __init__(self, sketch_size: int, sig_dtype, device: torch.device):
        self.sketch_size = sketch_size
        self.sig_dtype = np.dtype(sig_dtype)
        self.device = device
        self._sigs = np.empty((0, sketch_size), dtype=self.sig_dtype)
        self._device_sigs = None
        self._mxu = None

    @property
    def nb_points(self) -> int:
        return self._sigs.shape[0]

    def insert(self, sigs: np.ndarray) -> None:
        """Append signatures; ids are assigned consecutively (the SeqDict
        rank is the data id)."""
        if sigs.ndim != 2 or sigs.shape[1] != self.sketch_size:
            raise ValueError(f"expected [n, {self.sketch_size}] signatures, got {sigs.shape}")
        self._sigs = np.concatenate([self._sigs, sigs.astype(self.sig_dtype)], axis=0)
        self._device_sigs = None
        self._mxu = None

    def search(self, queries: np.ndarray, knbn: int, ef_search: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched k-NN: (distances [Q, k], ids [Q, k]); ef_search is
        accepted for interface parity and ignored (exact search)."""
        del ef_search
        trace.count("search.queries", queries.shape[0])
        with trace.span("search"):
            queries = queries.astype(self.sig_dtype, copy=False)
            if self.nb_points == 0:
                q = queries.shape[0]
                return np.full((q, 0), np.inf, np.float32), np.zeros((q, 0), np.int32)
            if self.device.type == "cuda" and self.nb_points >= self.MXU_MIN_POINTS:
                if self._mxu is None:
                    self._device_sigs = None  # the searcher holds its own bits
                    self._mxu = MxuSearcher(self._sigs, self.device)
                return self._mxu.search(queries, knbn)
            if self._device_sigs is None:
                self._device_sigs = as_int32_rows(self._sigs).to(self.device)
            return bucketed_knn(as_int32_rows(queries).to(self.device), self._device_sigs, knbn)

    def get_sigs(self) -> np.ndarray:
        return self._sigs

    # --- persistence ---------------------------------------------------------

    def save_arrays(self, prefix: str) -> dict:
        save_sigs(prefix, self._sigs)
        return {"sig_file": "index.sigs.npy"}

    @classmethod
    def load_arrays(cls, prefix: str, meta: dict, device: torch.device) -> "FlatIndex":
        sigs, _ = load_sigs(prefix)
        idx = cls(sketch_size=sigs.shape[1], sig_dtype=sigs.dtype, device=device)
        idx._sigs = sigs
        return idx
