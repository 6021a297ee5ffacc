"""FracMinHash (scaled MinHash), the `superaai` engine.

Counterpart of gsearch_tpu/models/fracminhash.py, bit-exact with it.  A
sketch keeps every k-mer whose hash falls below 2^32 / scaled: a
variable-size bottom sketch whose intersection over union on two genomes
estimates their Jaccard index.  The hash and the threshold mask run on the
device over 4M-symbol pieces; the surviving hashes (about genome / scaled
of them) are deduplicated and sorted on the host.  `num` keeps only the
smallest `num` hashes.  The sketch is a sorted u32 set, not an [S] row, so
this class has its own `sketch_codes` and never enters `sketch_submit`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.params import SeqSketcherParams
from ..ops.hash import mix2
from .base import SketcherBase, _as_codes, block_length

_HASH_SEED = 0xF3AC5EED


class FracMinHashSketcher(SketcherBase):
    """sketch_size is not used; `scaled` keeps ~1/scaled of the k-mers."""

    SIG_DTYPE = np.uint32

    def __init__(self, params: SeqSketcherParams, seed: int = 0x5EED,
                 scaled: int = 500, num: Optional[int] = None, *, device: torch.device):
        super().__init__(params, seed=seed, device=device)
        self.scaled = scaled
        self.num = num
        self._threshold = min(2**32 - 1, int(2**32 // scaled))

    def sketch_codes(self, codes) -> np.ndarray:
        """The sorted, deduplicated sub-threshold hash set of one genome."""
        codes = _as_codes(codes)
        n = len(codes)
        parts = []
        max_block = 1 << 22
        step = max_block - (self.k - 1)
        for start in range(0, max(n, 1), step):
            piece = codes[start : start + max_block]
            row = np.full(block_length(len(piece)), 255, dtype=np.uint8)
            row[: len(piece)] = piece
            hi, lo, valid = self._windows(torch.from_numpy(row).to(self.device))
            h = mix2(hi, lo, self.seed ^ _HASH_SEED)
            parts.append(h[valid & (h < self._threshold)].cpu().numpy().astype(np.uint32))
        hashes = np.unique(np.concatenate(parts)) if parts else np.empty(0, np.uint32)
        if self.num is not None and len(hashes) > self.num:
            hashes = hashes[: self.num]
        return hashes


def similarity(a: np.ndarray, b: np.ndarray) -> float:
    """Jaccard of two FracMinHash hash sets (sorted u32 arrays)."""
    if len(a) == 0 and len(b) == 0:
        return 0.0
    inter = len(np.intersect1d(a, b, assume_unique=True))
    union = len(a) + len(b) - inter
    return inter / union if union else 0.0


def containment(a: np.ndarray, b: np.ndarray) -> float:
    if len(a) == 0:
        return 0.0
    return len(np.intersect1d(a, b, assume_unique=True)) / len(a)
