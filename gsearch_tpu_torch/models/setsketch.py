"""SetSketch ("hll" mode): u16 register sketches.

Counterpart of gsearch_tpu/models/setsketch.py.  Each window throws
C = 2 arrivals at running sums of Exp(1) draws; slot s keeps the least
arrival time t_s and registers floor(20000 - ln(t_s) / ln(1.001)), clamped
to the u16 range, 0 where no dart landed.

Not bit-exact with gsearch_tpu: both logarithms go through
ops/hash.py `log_f32`, which differs from the reference's f32 log by an
ulp on some inputs, so a register at a level's edge can move by one.  The
level keeps the reference's true f32 division (a product with the
reciprocal moves three times as many registers).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.hash import M32, exp_from_bits, log_f32, mix2
from ..ops.race import RaceResult
from .base import SketcherBase

_SLOT_SEED = 0x5E75EED
_TIME_SEED = 0x7113D
_ARRIVALS = 2

_LOG_B = float(np.log(1.001))
_OFFSET = 20000.0


class SetSketchSketcher(SketcherBase):
    SIG_DTYPE = np.uint16

    arrivals: int = _ARRIVALS

    def _darts(self, hi, lo, valid):
        slots_l, keys_l = [], []
        t = torch.zeros(hi.shape, dtype=torch.float32, device=hi.device)
        for j in range(self.arrivals):
            t = t + exp_from_bits(mix2(hi, lo, (self.seed ^ _TIME_SEED ^ (j * 0x9E3779B9)) & M32))
            slots_l.append(mix2(hi, lo, (self.seed ^ _SLOT_SEED ^ (j * 0x85EBCA6B)) & M32)
                           % self.nb_slots)
            keys_l.append(t.view(torch.int32).to(torch.int64))  # positive f32 bits
        return (torch.cat(slots_l, dim=-1), torch.cat(keys_l, dim=-1), None,
                torch.cat([valid] * self.arrivals, dim=-1))

    def _finalize_race(self, race: RaceResult) -> torch.Tensor:
        bits = torch.where(race.found, race.key, 0).to(torch.int32)
        t = torch.clamp(bits.view(torch.float32), min=1e-30)  # guard log(0)
        # the divisor is a 0-dim tensor: CUDA torch turns division by a
        # Python scalar into a product with its reciprocal
        log_b = torch.tensor(_LOG_B, dtype=torch.float32, device=t.device)
        level = torch.clamp(torch.floor(_OFFSET - log_f32(t) / log_b), 0.0, 65535.0)
        # empty slots register 0 (the SetSketch "zero register")
        return torch.where(race.found, level, 0.0).to(torch.int64)
