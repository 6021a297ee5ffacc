"""ProbMinHash: weighted (probability) Jaccard sketching.

Counterpart of gsearch_tpu/models/probminhash.py.  One device sort of the
k-mer stream groups equal k-mers; run starts and lengths (the
multiplicities m_x) fall out of a forward cummax and a reverse cummin.
Each distinct element x then throws C = 3 arrivals at uniform slots, at
times Gamma_j(x) / m_x with Gamma_j a running sum of Exp(1) draws seeded by
x alone, into the exact race; the signature is a 32-bit fingerprint of
each slot's winner (u32).

Not bit-exact with gsearch_tpu: the Exp(1) draws take an f32 logarithm
(ops/hash.py `log_f32`), so two darts of one slot whose times lie an ulp
apart can swap.  Everything else (the sort, the multiplicities, the f32
reciprocal and product, the race) is exact.

Multiplicities are per piece for genomes past the 2^23 block, as in the
reference; pieces overlap by exactly k - 1 (MULTIPLICITY_SENSITIVE).

Traced (utils/trace.py) as spans `sketch.prob.sort`, `sketch.prob.runs` and
`sketch.prob.arrivals`, with counters `sketch.kmer_windows` and
`sketch.darts` taken from the shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.hash import M32, exp_from_bits, mix2
from ..ops.race import RaceResult
from ..utils import trace
from .base import SketcherBase

_RANK_SEED = 0xA11CE5
_SLOT_SEED = 0xB0B5EED
_PAY_SEED = 0xCAFEF00D
_ARRIVALS = 3


class ProbMinHashSketcher(SketcherBase):
    SIG_DTYPE = np.uint32
    MULTIPLICITY_SENSITIVE = True
    MAX_BLOCK_LOG2 = 23
    # USE_PACKED_PAYLOAD_RACE stays off, as in the reference: the pre-reduce
    # assumes a dart density that duplication-heavy genomes undercut

    arrivals: int = _ARRIVALS

    def _darts(self, hi, lo, valid):
        dev = hi.device
        trace.count("sketch.kmer_windows", hi.numel())
        trace.count("sketch.darts", self.arrivals * hi.numel())
        # 1. group equal k-mers: sort (hi, lo) as one biased int64 (signed
        # order == unsigned pair order), invalid windows at the far end
        with trace.span("sketch.prob.sort", dev):
            khi = torch.where(valid, hi, M32)
            klo = torch.where(valid, lo, M32)
            word = torch.sort(((khi - (1 << 31)) << 32) | klo, dim=-1).values
            s_hi, s_lo = (word >> 32) + (1 << 31), word & M32
            s_valid = ~((s_hi == M32) & (s_lo == M32))

        # 2. run starts and multiplicities
        with trace.span("sketch.prob.runs", dev):
            n = word.shape[-1]
            iota = torch.arange(n, dtype=torch.int64, device=dev).expand(word.shape)
            is_start = torch.ones_like(s_valid)
            is_start[..., 1:] = word[..., 1:] != word[..., :-1]
            is_start[..., 0] = s_valid[..., 0]  # the reference pads with the sentinel pair
            run_start = torch.cummax(torch.where(is_start, iota, 0), dim=-1).values
            is_rep = iota == run_start  # one dart source per run
            nxt = torch.where(is_start, iota, n).flip(-1).cummin(dim=-1).values.flip(-1)
            next_start = torch.full_like(nxt, n)
            next_start[..., :-1] = nxt[..., 1:]
            mult = (next_start - run_start).to(torch.float32)
            inv_m = torch.where(mult > 0, 1.0 / mult, 1.0)

        # 3. C arrivals per distinct element, times scaled by 1/m_x
        with trace.span("sketch.prob.arrivals", dev):
            slots_l, keys_l = [], []
            t = torch.zeros(word.shape, dtype=torch.float32, device=dev)
            for j in range(self.arrivals):
                sub_seed = (self.seed ^ _RANK_SEED ^ (j * 0x9E3779B9)) & M32
                t = t + exp_from_bits(mix2(s_hi, s_lo, sub_seed))
                slots_l.append(mix2(s_hi, s_lo, sub_seed ^ _SLOT_SEED) % self.nb_slots)
                # positive f32 bits order as integers
                keys_l.append((t * inv_m).view(torch.int32).to(torch.int64))
            payload = mix2(s_hi, s_lo, self.seed ^ _PAY_SEED)
            rep_valid = s_valid & is_rep
            return (torch.cat(slots_l, dim=-1), torch.cat(keys_l, dim=-1),
                    torch.cat([payload] * self.arrivals, dim=-1),
                    torch.cat([rep_valid] * self.arrivals, dim=-1))

    def _finalize_race(self, race: RaceResult) -> torch.Tensor:
        return torch.where(race.found, race.payload, self._filler(race, 0xD00DF00D))
