"""SuperMinHash: the f32 "SUPER" and the integer "SUPER2" variants.

Counterpart of gsearch_tpu/models/superminhash.py, bit-exact with it
(integer arithmetic and exact int -> f32 conversions only).  Element x
throws, for arrival j = 0 .. C-1, one dart of key (j << 24 | 24-bit u_j(x))
at slot H(x, j) mod S, with a 32-bit fingerprint of x as payload; the exact
race keeps each slot's least (key, payload).  SUPER stores the winning
value j + u_j as f32, SUPER2 the winner's fingerprint as u32; empty slots
take a genome-dependent filler that never matches another genome's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.hash import M32, mix2
from ..ops.race import RaceResult
from .base import SketcherBase

_SLOT_SEED = 0x51075EED
_VAL_SEED = 0x4A1B2C3D
_PAY_SEED = 0xFEEDC0DE
_ARRIVALS = 2


class SuperMinHashSketcher(SketcherBase):
    SIG_DTYPE = np.float32

    arrivals: int = _ARRIVALS

    def _darts(self, hi, lo, valid):
        slots_l, keys_l = [], []
        for j in range(self.arrivals):
            h_slot = mix2(hi, lo, (self.seed ^ _SLOT_SEED ^ (j * 0x9E3779B9)) & M32)
            h_val = mix2(hi, lo, (self.seed ^ _VAL_SEED ^ (j * 0x85EBCA6B)) & M32)
            slots_l.append(h_slot % self.nb_slots)
            keys_l.append((j << 24) | (h_val >> 8))
        payload = mix2(hi, lo, self.seed ^ _PAY_SEED)
        return (torch.cat(slots_l, dim=-1), torch.cat(keys_l, dim=-1),
                torch.cat([payload] * self.arrivals, dim=-1),
                torch.cat([valid] * self.arrivals, dim=-1))

    def _finalize_race(self, race: RaceResult) -> torch.Tensor:
        v = (race.key >> 24).to(torch.float32) + (race.key & 0xFFFFFF).to(torch.float32) * (
            1.0 / (1 << 24))
        # int64 -> f32 rounds to nearest even, as the reference's u32 -> f32
        filler = 1e6 + self._filler(race, 0xF111E4).to(torch.float32)
        return torch.where(race.found, v, filler)


class SuperMinHash2Sketcher(SuperMinHashSketcher):
    SIG_DTYPE = np.uint32

    def _finalize_race(self, race: RaceResult) -> torch.Tensor:
        return torch.where(race.found, race.payload, self._filler(race, 0xBAD5EED5))
