"""HyperMinHash sketches (the `hypermash` tool's engine).

Counterpart of gsearch_tpu/models/hyperminhash.py, bit-exact with it.  A
register packs an HLL exponent (leading-zero count, q bits) with a MinHash
fraction (r bits), encoded so that a smaller key means more leading zeros,
then a smaller fraction, and raced with the exact `bucket_min`:

    slot = H1(kmer) mod buckets
    key  = (63 - lz(H2)) << r | fraction(H3)

Register 0 means "empty".  `union`, `cardinality` and `similarity` run on
host registers (numpy), as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.params import SeqSketcherParams
from ..ops.hash import mix2
from ..ops.race import RaceResult
from .base import SketcherBase

Q_BITS = 6   # exponent field width (lz counts 0..63, stored inverted)
R_BITS = 10  # minhash fraction bits
_SLOT_SEED = 0x44D5EED
_LZ_SEED = 0x1F2E3D4C
_FRAC_SEED = 0x99AA55EE


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of a u32 carrier, by a bit loop; 32 for 0."""
    n = torch.zeros_like(x)
    y = x
    for shift in (16, 8, 4, 2, 1):
        has = y >= (1 << shift)
        n = torch.where(has, n + shift, n)
        y = torch.where(has, y >> shift, y)
    return torch.where(x == 0, 32, 31 - n)


class HyperMinHashSketcher(SketcherBase):
    """sketch_size is the number of buckets (2^p recommended)."""

    SIG_DTYPE = np.uint16

    def _darts(self, hi, lo, valid):
        slots = mix2(hi, lo, self.seed ^ _SLOT_SEED) % self.nb_slots
        lz = _clz32(mix2(hi, lo, self.seed ^ _LZ_SEED))  # 0..32
        frac = mix2(hi, lo, self.seed ^ _FRAC_SEED) >> (32 - R_BITS)
        # smaller key <=> larger lz, then smaller fraction
        return slots, ((63 - lz) << R_BITS) | frac, None, valid

    def _finalize_race(self, race: RaceResult) -> torch.Tensor:
        # register = key + 1 so that 0 remains "empty"
        return torch.clamp(torch.where(race.found, race.key + 1, 0), 0, 65535)


def union(reg_a: np.ndarray, reg_b: np.ndarray) -> np.ndarray:
    """Union of two sketches: per-slot best (minimal non-zero) register."""
    a, b = reg_a.astype(np.uint32), reg_b.astype(np.uint32)
    out = np.where(a == 0, b, np.where(b == 0, a, np.minimum(a, b)))
    return out.astype(np.uint16)


def cardinality(reg: np.ndarray) -> float:
    """HLL harmonic-mean estimator on the exponent field."""
    m = reg.shape[-1]
    filled = reg != 0
    lz = np.where(filled, 63 - ((reg.astype(np.uint32) - 1) >> R_BITS), 0)
    # HLL register value rho = lz + 1 for filled, 0 for empty
    rho = np.where(filled, lz + 1, 0).astype(np.float64)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    est = alpha * m * m / np.sum(np.power(2.0, -rho))
    zeros = int((~filled).sum())
    if est <= 2.5 * m and zeros > 0:  # small-range correction
        est = m * np.log(m / zeros)
    return float(est)


def _expected_collisions(n: float, m: float, nb_buckets: int) -> float:
    """Expected register collisions between two independent sketches of
    cardinalities n, m (Yu & Weber 2017, large-range approximation)."""
    if n <= 0 or m <= 0:
        return 0.0
    if n < m:
        n, m = m, n
    ratio = n / m
    phi = (4.0 * ratio) / ((1.0 + ratio) ** 2)
    collision_const = 0.169919487159739093975315012348
    return collision_const * nb_buckets * phi * (2.0 ** -R_BITS)


def similarity(reg_a: np.ndarray, reg_b: np.ndarray) -> float:
    """Jaccard estimate: matching non-empty registers over occupied slots,
    corrected for expected random collisions (arXiv 1710.08436, 3.3)."""
    a, b = reg_a, reg_b
    both = (a != 0) & (b != 0)
    either = (a != 0) | (b != 0)
    n_occ = int(either.sum())
    if n_occ == 0:
        return 0.0
    c = int((both & (a == b)).sum())
    ec = _expected_collisions(cardinality(a), cardinality(b), reg_a.shape[-1])
    return max(0.0, (c - ec) / n_occ)


def make_hyperminhash(nb_buckets: int = 4096, kmer_size: int = 16, is_aa: bool = False,
                      seed: int = 0x5EED, *, device: torch.device) -> HyperMinHashSketcher:
    params = SeqSketcherParams(
        kmer_size=kmer_size,
        sketch_size=nb_buckets,
        algo="OPTDENS",  # placeholder enum slot; this class ignores it
        data_t="AA" if is_aa else "DNA",
    )
    return HyperMinHashSketcher(params, seed=seed, device=device)
