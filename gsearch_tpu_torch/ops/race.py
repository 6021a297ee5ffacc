"""The packed dart race: per-slot minimum over hashed darts.

Counterpart of gsearch_tpu/ops/race.py for the payload-free race that
OptDens and RevOptDens run.  Each dart packs (key high bits | slot) in one
u32 word (u32 carrier in int64, see ops/hash.py), so one scatter-min keeps
each slot's winning dart.

The windowed pre-reduce of the reference (W=32 positions, the K=6
smallest distinct words per window, applied when the row is long enough
for the gate) is replicated exactly.  It drops a slot's true winner with
probability <= ~1e-4 on gated shapes, and which winners it drops depends on
the row's window partition, so replicating it is what keeps signatures
bit-exact with gsearch_tpu on every shape.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .hash import M32


class RaceResult(NamedTuple):
    found: torch.Tensor    # bool [..., S]: slot received at least one dart
    key: torch.Tensor      # u32 carrier [..., S]: minimal key (M32 where !found)
    payload: torch.Tensor  # u32 carrier [..., S]: payload of the winning dart


def combine_race(a: RaceResult, b: RaceResult) -> RaceResult:
    """Associative merge of two partial races (elementwise min by
    (key, payload) with found-ness dominance)."""
    a_wins = a.found & (
        ~b.found | (a.key < b.key) | ((a.key == b.key) & (a.payload <= b.payload))
    )
    return RaceResult(
        found=a.found | b.found,
        key=torch.where(a_wins, a.key, b.key),
        payload=torch.where(a_wins, a.payload, b.payload),
    )


_PR_WINDOW = 32      # pre-reduce window width
_PR_KEEP = 6         # darts kept per window


def prereduce_gated(n: int, nb_slots: int) -> bool:
    """The reference's static gate (gsearch_tpu/ops/race.py:134): rows whose
    worst-case darts-per-slot (a genome fills at least half its block)
    is >= 40 are pre-reduced."""
    return n % _PR_WINDOW == 0 and (n // 2) / nb_slots >= 40


def bucket_min_packed(
    slots: torch.Tensor,
    keys: torch.Tensor,
    nb_slots: int,
    valid: Optional[torch.Tensor] = None,
) -> RaceResult:
    """Per-slot minimum dart over the last axis.

    slots: int64 [..., n] in [0, nb_slots); keys: u32 carrier [..., n];
    valid: optional bool [..., n].  A slot's key is the winning packed word
    (key high bits | slot), as in the reference."""
    slot_bits = max(1, nb_slots.bit_length())
    low_mask = (1 << slot_bits) - 1
    dart = (keys & (M32 ^ low_mask)) | slots
    if valid is None:
        valid = slots < nb_slots
    dart = torch.where(valid, dart, M32)

    batch_shape = dart.shape[:-1]
    n = dart.shape[-1]
    if prereduce_gated(n, nb_slots):
        # window g = positions [g*W, (g+1)*W); column j of the [.., n/W, W]
        # view is the reference's strided slice dart[..., j::W].  The K-deep
        # insertion chain keeps the K smallest distinct words per window;
        # exact duplicates (repeat k-mers) are dropped as they enter.
        win = dart.reshape(batch_shape + (n // _PR_WINDOW, _PR_WINDOW))
        mins = [torch.full(win.shape[:-1], M32, dtype=torch.int64, device=dart.device)
                for _ in range(_PR_KEEP)]
        for j in range(_PR_WINDOW):
            x = win[..., j]
            for i in range(_PR_KEEP):
                dup = x == mins[i]
                new_min = torch.minimum(mins[i], x)
                x = torch.where(dup, M32, torch.maximum(mins[i], x))
                mins[i] = new_min
        dart = torch.cat(mins, dim=-1)

    # sentinel darts land in column low_mask >= nb_slots and are sliced off
    out = torch.full(batch_shape + (1 << slot_bits,), M32, dtype=torch.int64, device=dart.device)
    out.scatter_reduce_(-1, dart & low_mask, dart, reduce="amin", include_self=True)
    out = out[..., :nb_slots]
    # a real dart never equals M32: its slot bits are < nb_slots <= low_mask
    return RaceResult(found=out != M32, key=out, payload=out)


def sketch_fingerprint(race: RaceResult) -> torch.Tensor:
    """Per-genome min over found keys (keepdim), which makes empty-slot
    fillers genome-dependent."""
    return torch.where(race.found, race.key, M32).amin(dim=-1, keepdim=True)


def empty_race(batch_shape: tuple, nb_slots: int, device: torch.device) -> RaceResult:
    shape = tuple(batch_shape) + (nb_slots,)
    return RaceResult(
        found=torch.zeros(shape, dtype=torch.bool, device=device),
        key=torch.full(shape, M32, dtype=torch.int64, device=device),
        payload=torch.zeros(shape, dtype=torch.int64, device=device),
    )
