"""BIGSI: a bit-sliced Bloom-filter index over genomes, for read classification.

Counterpart of gsearch_tpu/index/bigsi.py on one torch device, with the
same files (`<prefix>.bigsi.npz` + `<prefix>.bigsi.json`): an index saved by
either package loads in the other.  The matrix is uint32 words
[bloom_len, ceil(N / 32)] on the host: row r holds the N-genome bit slice of
Bloom position r, genome j in bit j % 32 of word j // 32.  Its device copy
is uploaded once per insert state, as int32 bit patterns.

A genome sets the bits of its k-mers' h Bloom positions; a read batch is
classified by gathering the h row slices of each k-mer, AND-ing them and
counting, for every genome, the k-mers whose AND has its bit set.
Minimizer mode keeps only the k-mers that are the minimum of their
w-window of hashes, in the index and in the reads alike.

Hashes and positions are u32 values carried in int64 (ops/hash.py).  Hash j
is seeded with `(seed ^ _POS_SEED ^ (j * 0x9E3779B9)) & 0xFFFFFFFF`, which
is gsearch_tpu's seed for j <= 1; gsearch_tpu cannot hash with j >= 2 (its
seed leaves 32 bits and its mixer raises), so indexes with three or more
hashes exist only in this package.
"""

from __future__ import annotations

import json
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.base import block_length
from ..ops.hash import M32, mix2
from ..ops.kmer import canonical_dna_windows

_POS_SEED = 0xB165B165
_MINI_SEED = 0x3141
_MAX_PIECE = 1 << 22  # bases a genome piece, as the reference's block


def _binom_sf_log10(k: int, n: int, p: float) -> float:
    """log10 P(X >= k) for X ~ Binomial(n, p), summed exactly in log space."""
    if k <= 0:
        return 0.0
    if p <= 0.0:
        return -math.inf
    if p >= 1.0:
        return 0.0
    lp, lq = math.log(p), math.log1p(-p)
    lgn = math.lgamma(n + 1)
    terms = [
        lgn - math.lgamma(j + 1) - math.lgamma(n - j + 1) + j * lp + (n - j) * lq
        for j in range(k, n + 1)
    ]
    m = max(terms)
    return (m + math.log(sum(math.exp(t - m) for t in terms))) / math.log(10)


def window_min_same(h: torch.Tensor, w: int) -> torch.Tensor:
    """Minimum of each stride-1 window of w along the last axis, aligned as
    XLA's "SAME" padding aligns it: (w - 1) // 2 positions of 0xFFFFFFFF
    before, the rest after (so odd and even w centre differently)."""
    lo = (w - 1) // 2
    padded = F.pad(h, (lo, w - 1 - lo), value=M32)
    return padded.unfold(-1, w, 1).amin(-1)


def hash_seed(seed: int, j: int) -> int:
    """The 32-bit seed of Bloom hash j."""
    return (seed ^ _POS_SEED ^ (j * 0x9E3779B9)) & M32


class BigsiIndex:
    def __init__(self, bloom_len: int, nb_hashes: int, kmer_size: int,
                 minimizer_window: int = 0, seed: int = 0x5EED, *, device: torch.device):
        self.bloom_len = bloom_len
        self.nb_hashes = nb_hashes
        self.kmer_size = kmer_size
        self.minimizer_window = minimizer_window  # 0 = plain k-mer mode
        self.seed = seed
        self.device = device
        self.names: List[str] = []
        self._bits: Optional[np.ndarray] = None  # uint32 [bloom_len, Nw], host
        self._device_bits: Optional[torch.Tensor] = None  # int32 copy, per insert state
        self._ones_per_genome: List[int] = []

    @property
    def nb_genomes(self) -> int:
        return len(self.names)

    # ------------------------------------------------------------- device ops

    def positions(self, codes: torch.Tensor, down_sample: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """uint8 codes [..., L] on the device -> (Bloom positions [h, ..., L]
        int64, valid [..., L]): a k-mer is valid when it holds no invalid
        code, is probed (index % down_sample == 0) and, in minimizer mode,
        is the minimum of its window."""
        hi, lo, valid = canonical_dna_windows(codes, self.kmer_size)
        if down_sample > 1:
            keep = torch.arange(valid.shape[-1], device=valid.device) % down_sample == 0
            valid = valid & keep
        if self.minimizer_window > 1:
            h = mix2(hi, lo, self.seed ^ _MINI_SEED)
            h = torch.where(valid, h, M32)
            valid = valid & (h == window_min_same(h, self.minimizer_window))
        pos = torch.stack([mix2(hi, lo, hash_seed(self.seed, j)) % self.bloom_len
                           for j in range(self.nb_hashes)])
        return pos, valid

    def _genome_positions(self, codes: np.ndarray) -> np.ndarray:
        """Every Bloom position a genome sets, sorted and unique: pieces of
        2^22 bases overlapping by k - 1, each padded to its block length
        with invalid codes, marked in a [bloom_len] bool map."""
        seen = torch.zeros(self.bloom_len, dtype=torch.bool, device=self.device)
        step = _MAX_PIECE - (self.kmer_size - 1)
        for start in range(0, max(len(codes), 1), step):
            piece = codes[start : start + _MAX_PIECE]
            nb = block_length(len(piece))
            if len(piece) < nb:
                piece = np.pad(piece, (0, nb - len(piece)), constant_values=255)
            pos, valid = self.positions(torch.from_numpy(np.ascontiguousarray(piece)).to(self.device))
            seen[pos[:, valid].reshape(-1)] = True
        return seen.nonzero().squeeze(1).cpu().numpy()

    # ------------------------------------------------------------------ build

    def insert_genome(self, name: str, codes: np.ndarray) -> None:
        """Set genome j's bit column (j = the number inserted before it)."""
        j = len(self.names)
        self.names.append(name)
        self._device_bits = None
        nw_needed = (j // 32) + 1
        if self._bits is None:
            self._bits = np.zeros((self.bloom_len, nw_needed), dtype=np.uint32)
        elif self._bits.shape[1] < nw_needed:
            pad = np.zeros((self.bloom_len, nw_needed - self._bits.shape[1]), np.uint32)
            self._bits = np.concatenate([self._bits, pad], axis=1)
        pos = self._genome_positions(codes)
        self._bits[pos, j // 32] |= np.uint32(1 << (j % 32))
        self._ones_per_genome.append(len(pos))

    # ------------------------------------------------------------------ query

    def device_bits(self) -> torch.Tensor:
        """The bit matrix on the device as int32 bit patterns [bloom_len, Nw]."""
        if self._device_bits is None:
            self._device_bits = torch.from_numpy(self._bits.view(np.int32)).to(self.device)
        return self._device_bits

    def raw_counts(self, reads: np.ndarray, down_sample: int = 1
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Per read and genome the k-mer hit counts, and per read the k-mers
        probed ([R, G] int32, [R] int32), for uint8 reads [R, L]; exposed so
        paired-end callers can sum both mates' counts before scoring."""
        bits = self.device_bits()
        codes = torch.from_numpy(np.ascontiguousarray(reads, np.uint8)).to(self.device)
        pos, valid = self.positions(codes, down_sample)
        agg = bits[pos[0]]
        for j in range(1, self.nb_hashes):
            agg = agg & bits[pos[j]]
        agg = torch.where(valid[..., None], agg, 0)  # [R, L, Nw] int32
        # one bit position at a time: the largest temporary is [R, L, Nw]
        # int32 (4 x 4,096 x 236 x 32 bytes = 124 MB at 1,024 genomes and
        # 256-base reads), not the [R, L, Nw, 32] expansion
        counts = torch.stack([((agg >> b) & 1).sum(1) for b in range(32)], dim=-1)
        counts = counts.reshape(codes.shape[0], -1)[:, : self.nb_genomes]
        return (counts.to(torch.int32).cpu().numpy(),
                valid.sum(-1).to(torch.int32).cpu().numpy())

    def fp_rates(self) -> np.ndarray:
        """Per-genome Bloom false-positive rate (ones / m)^h."""
        ones = np.array(self._ones_per_genome, dtype=np.float64)
        return (ones / self.bloom_len) ** self.nb_hashes

    def score_counts(
        self,
        counts: np.ndarray,
        totals: np.ndarray,
        min_fraction: float = 0.7,
        fp_exponent: float = 0.0,
    ) -> List[List[Tuple[str, int, int, float]]]:
        """Per read, the genomes whose false-positive-corrected hit fraction
        (hits - fp * total) / total reaches min_fraction, and, with
        fp_exponent > 0, whose binomial tail P(X >= hits | Bin(total, fp))
        is below 10^-fp_exponent: (name, hits, total, corrected fraction),
        best first."""
        fp = self.fp_rates()
        out = []
        for i in range(counts.shape[0]):
            t = int(totals[i])
            hits = []
            if t > 0:
                expected_fp = fp * t
                corrected = (counts[i] - expected_fp) / t
                for g in np.nonzero(corrected >= min_fraction)[0]:
                    if fp_exponent > 0.0 and _binom_sf_log10(
                            int(counts[i][g]), t, fp[g]) >= -fp_exponent:
                        continue
                    hits.append((self.names[g], int(counts[i][g]), t, float(corrected[g])))
                hits.sort(key=lambda x: -x[3])
            out.append(hits)
        return out

    def classify(
        self, reads: np.ndarray, min_fraction: float = 0.7,
        down_sample: int = 1, fp_exponent: float = 0.0,
    ) -> List[List[Tuple[str, int, int, float]]]:
        """Classify a batch of fixed-length reads (uint8 codes [R, L])."""
        counts, totals = self.raw_counts(reads, down_sample)
        return self.score_counts(counts, totals, min_fraction, fp_exponent)

    # --------------------------------------------------------------------- io

    def save(self, path_prefix: str) -> None:
        """`<prefix>.bigsi.npz` (bits, ones) and `<prefix>.bigsi.json`.  The
        archive is stored, not deflated as gsearch_tpu's is: at real fills
        the words are near-random bits that zlib barely shrinks, and
        deflating them was most of `bigsig construct`'s wall (PERF.md §5).
        np.load reads either form, so each package loads the other's."""
        np.savez(
            path_prefix + ".bigsi.npz",
            bits=self._bits,
            ones=np.array(self._ones_per_genome, dtype=np.int64),
        )
        with open(path_prefix + ".bigsi.json", "w") as f:
            json.dump(
                {
                    "bloom_len": self.bloom_len,
                    "nb_hashes": self.nb_hashes,
                    "kmer_size": self.kmer_size,
                    "minimizer_window": self.minimizer_window,
                    "seed": self.seed,
                    "names": self.names,
                },
                f,
            )

    @classmethod
    def load(cls, path_prefix: str, *, device: torch.device) -> "BigsiIndex":
        with open(path_prefix + ".bigsi.json") as f:
            meta = json.load(f)
        idx = cls(
            bloom_len=meta["bloom_len"],
            nb_hashes=meta["nb_hashes"],
            kmer_size=meta["kmer_size"],
            minimizer_window=meta["minimizer_window"],
            seed=meta["seed"],
            device=device,
        )
        with np.load(path_prefix + ".bigsi.npz") as data:
            idx._bits = data["bits"]
            idx._ones_per_genome = data["ones"].tolist()
        idx.names = meta["names"]
        return idx

    @classmethod
    def from_jax(cls, jax_index, *, device: torch.device) -> "BigsiIndex":
        """The port's copy of a gsearch_tpu BigsiIndex (same bits, names,
        fill counts and parameters)."""
        idx = cls(jax_index.bloom_len, jax_index.nb_hashes, jax_index.kmer_size,
                  jax_index.minimizer_window, jax_index.seed, device=device)
        idx.names = list(jax_index.names)
        idx._bits = None if jax_index._bits is None else np.array(jax_index._bits, np.uint32)
        idx._ones_per_genome = list(jax_index._ones_per_genome)
        return idx
