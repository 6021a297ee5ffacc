"""The dart race: per-slot minimum over hashed darts.

Counterpart of gsearch_tpu/ops/race.py.  Three forms:
  - `bucket_min`, the exact race with an optional payload: a slot's winner
    is the dart with the least (key, payload).  The reference sorts the
    darts by (slot, key, payload) and looks each slot's run head up; a
    winner is only its slot's (key, payload) minimum, so here one
    scatter-min of the int64 word (key << 32 | payload) finds it, in any
    dart order (deterministic on CUDA);
  - `bucket_min_packed`, the payload-free race of OptDens and RevOptDens:
    each dart packs (key high bits | slot) in one u32 word (u32 carrier in
    int64, see ops/hash.py), so one scatter-min keeps each slot's winner;
  - `bucket_min_packed_payload`, the packed race that carries a payload
    through the pre-reduce (no sketcher turns it on, as in the reference).

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


_I64_MAX = (1 << 63) - 1


def bucket_min(
    slots: torch.Tensor,
    keys: torch.Tensor,
    nb_slots: int,
    payload: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
) -> RaceResult:
    """Per-slot minimum (key, payload) dart over the last axis.

    slots: int64 [..., n] in [0, nb_slots); keys: u32 carrier [..., n];
    payload: optional u32 carrier [..., n] (the key stands in when absent,
    as in the reference); valid: optional bool [..., n].  Invalid and
    out-of-range darts go to an overflow slot == nb_slots.  Where a slot
    received no dart, key is M32 and payload 0 (the reference leaves both
    undefined there)."""
    ok = (slots >= 0) & (slots < nb_slots)
    if valid is not None:
        ok = ok & valid
    slots = torch.where(ok, slots, nb_slots)
    # (key - 2^31) << 32 | payload: signed int64 order == unsigned (key, payload) order
    word = ((keys - (1 << 31)) << 32) | (keys if payload is None else payload)
    shape = slots.shape[:-1] + (nb_slots + 1,)
    out = torch.full(shape, _I64_MAX, dtype=torch.int64, device=slots.device)
    out.scatter_reduce_(-1, slots, word, reduce="amin", include_self=True)
    # found by its own scatter: a real dart may equal the initial word
    found = torch.zeros(shape, dtype=torch.bool, device=slots.device).scatter_(-1, slots, True)
    out, found = out[..., :nb_slots], found[..., :nb_slots]
    return RaceResult(found=found,
                      key=torch.where(found, (out >> 32) + (1 << 31), M32),
                      payload=torch.where(found, out & M32, 0))


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


def bucket_min_packed_payload(
    slots: torch.Tensor,
    keys: torch.Tensor,
    payload: torch.Tensor,
    nb_slots: int,
    valid: Optional[torch.Tensor] = None,
) -> RaceResult:
    """The packed race with a payload swapped along the pre-reduce chain:
    one scatter-min of (key high bits | payload low bits).  The winner is
    chosen on the key's top (32 - slot_bits) bits, ties by the payload's
    low bits, and the payload keeps slot_bits bits; bit-exact with the
    reference's `bucket_min_packed_payload`."""
    slot_bits = max(1, nb_slots.bit_length())
    low_mask = (1 << slot_bits) - 1
    hi_mask = M32 ^ low_mask
    word = (keys & hi_mask) | slots
    if valid is None:
        valid = slots < nb_slots
    word = torch.where(valid, word, M32)

    batch_shape = word.shape[:-1]
    n = word.shape[-1]
    if prereduce_gated(n, nb_slots):
        win = word.reshape(batch_shape + (n // _PR_WINDOW, _PR_WINDOW))
        pwin = payload.reshape(win.shape)
        mins = [torch.full(win.shape[:-1], M32, dtype=torch.int64, device=word.device)
                for _ in range(_PR_KEEP)]
        pays = [torch.zeros(win.shape[:-1], dtype=torch.int64, device=word.device)
                for _ in range(_PR_KEEP)]
        for j in range(_PR_WINDOW):
            x, px = win[..., j], pwin[..., j]
            for i in range(_PR_KEEP):
                dup = x == mins[i]
                smaller = x < mins[i]
                new_min = torch.where(smaller, x, mins[i])
                new_pay = torch.where(smaller, px, pays[i])
                x, px = (torch.where(dup, M32, torch.where(smaller, mins[i], x)),
                         torch.where(smaller, pays[i], px))
                mins[i], pays[i] = new_min, new_pay
        word = torch.cat(mins, dim=-1)
        payload = torch.cat(pays, dim=-1)

    word2 = torch.where(word == M32, M32, (word & hi_mask) | (payload & low_mask))
    out = torch.full(batch_shape + (1 << slot_bits,), M32, dtype=torch.int64, device=word.device)
    out.scatter_reduce_(-1, word & low_mask, word2, reduce="amin", include_self=True)
    out = out[..., :nb_slots]
    return RaceResult(found=out != M32, key=out & hi_mask, payload=out & low_mask)


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
