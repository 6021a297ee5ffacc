"""One-permutation hashing with optimal / reverse-optimal densification.

Counterpart of gsearch_tpu/models/optdens.py, bit-exact with it.  Each
k-mer throws one dart (slot = H1(kmer) mod S, key = H2(kmer)); empty slots
are then filled over 32 rounds of probes into originally-occupied slots,
with a genome-dependent filler for slots no probe reaches.  The signature
is the winning key mapped to f32 in [0, 1).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.hash import mix2, mix32, uniform01
from ..ops.race import RaceResult
from .base import SketcherBase

_SLOT_SEED = 0x0BADF00D
_KEY_SEED = 0x5CA1AB1E
_DENS_ROUNDS = 32

_M32 = 0xFFFFFFFF


def _mix32_py(x: int) -> int:
    """Host-side lowbias32 (matches ops.hash.mix32 for static scalars)."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    x ^= x >> 16
    return x


class OptDensSketcher(SketcherBase):
    SIG_DTYPE = np.float32
    USE_PACKED_RACE = True
    _DENS_FAMILY = 0x0D15EA5E  # probe-hash family seed

    def _darts(self, hi, lo, valid):
        slots = mix2(hi, lo, self.seed ^ _SLOT_SEED) % self.nb_slots
        keys = mix2(hi, lo, self.seed ^ _KEY_SEED)
        return slots, keys, None, valid

    def _densify(self, race: RaceResult) -> torch.Tensor:
        """Fill empty slots by probing originally-occupied ones."""
        s = self.nb_slots
        idx = torch.arange(s, dtype=torch.int64, device=race.key.device)
        key = torch.where(race.found, race.key, 0)
        out_key = key
        still_empty = ~race.found
        for r in range(_DENS_ROUNDS):
            tgt = mix32(idx, self.seed ^ self._DENS_FAMILY ^ (r * 0x9E37)) % s
            tgt_found = race.found[..., tgt]
            out_key = torch.where(still_empty & tgt_found, key[..., tgt], out_key)
            still_empty = still_empty & ~tgt_found
        # near-empty sketch: a genome-dependent filler, so two sparse genomes
        # never agree on commonly-empty slots
        return torch.where(still_empty, self._filler(race, 0xDEADBEEF), out_key)

    def _finalize_race(self, race: RaceResult) -> torch.Tensor:
        return uniform01(self._densify(race))


class RevOptDensSketcher(OptDensSketcher):
    """Reverse-optimal densification: per round every bin is rotated by a
    host-computed offset a_r, so the push of non-empty bins inverts into a
    gather (empty bin i reads source (i - a_r) mod S)."""

    def _densify(self, race: RaceResult) -> torch.Tensor:
        s = self.nb_slots
        idx = torch.arange(s, dtype=torch.int64, device=race.key.device)
        key = torch.where(race.found, race.key, 0)
        out_key = key
        still_empty = ~race.found
        for r in range(_DENS_ROUNDS):
            a_r = _mix32_py(r ^ self.seed ^ 0x7E57AB1E) % max(s - 1, 1) + 1
            src = (idx + (s - a_r)) % s
            src_found = race.found[..., src]
            out_key = torch.where(still_empty & src_found, key[..., src], out_key)
            still_empty = still_empty & ~src_found
        return torch.where(still_empty, self._filler(race, 0xDEADBEEF), out_key)
