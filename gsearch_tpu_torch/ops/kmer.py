"""All length-k windows of a code row, folded into (hi, lo) u32 pairs.

Counterpart of gsearch_tpu/ops/kmer.py, bit-exact with it at every
position (invalid windows included).  Codes arrive as a uint8 tensor
[..., L] (DNA 0..3, anything >= the alphabet size invalid); output i is the
k-mer starting at position i.  Both words are u32 carriers in int64 (see
ops/hash.py); the pair is kept, rather than one 64-bit word, because
`mix2` hashes exactly that pair.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .hash import M32

DNA_BITS = 2
AA_BITS = 5


def _shifted(codes: torch.Tensor, j: int) -> torch.Tensor:
    """codes[..., j:] left-aligned and padded at the end with invalid (255)."""
    if j == 0:
        return codes
    pad = torch.full(codes.shape[:-1] + (j,), 255, dtype=codes.dtype, device=codes.device)
    return torch.cat([codes[..., j:], pad], dim=-1)


def kmer_windows(
    codes: torch.Tensor, k: int, bits: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """uint8 [..., L] -> (hi, lo, valid), each [..., L]; hi is 0 for k*bits <= 32."""
    if not 1 <= k * bits <= 64:
        raise ValueError("compressed k-mer must fit 64 bits")
    limit = 4 if bits == DNA_BITS else 20
    hi = torch.zeros(codes.shape, dtype=torch.int64, device=codes.device)
    lo = torch.zeros_like(hi)
    valid = torch.ones(codes.shape, dtype=torch.bool, device=codes.device)
    for j in range(k):
        c = _shifted(codes, j)
        valid &= c < limit
        # 64-bit left shift by `bits` across the (hi, lo) pair, then or-in c
        hi = ((hi << bits) & M32) | (lo >> (32 - bits))
        lo = ((lo << bits) & M32) | c.to(torch.int64)
    return hi, lo, valid


def _rev2_32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit groups of a u32."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & M32) | (x >> 16)


def _pair_shr(hi: torch.Tensor, lo: torch.Tensor, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logical right shift of the (hi, lo) 64-bit pair by a static s."""
    if s == 0:
        return hi, lo
    if s < 32:
        return hi >> s, ((lo >> s) | (hi << (32 - s))) & M32
    if s == 32:
        return torch.zeros_like(hi), hi
    return torch.zeros_like(hi), hi >> (s - 32)


def reverse_complement(hi: torch.Tensor, lo: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reverse complement of 2-bit packed DNA k-mers held in (hi, lo):
    complement is NOT of each 2-bit group (A=0,C=1,G=2,T=3), reverse is a
    group reversal of the 64-bit pair re-aligned to the low 2k bits."""
    rhi, rlo = _rev2_32(lo ^ M32), _rev2_32(hi ^ M32)  # the reversal swaps words
    return _pair_shr(rhi, rlo, 64 - 2 * k)


def canonical_dna_windows(
    codes: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All k-windows as canonical (min of k-mer and reverse complement) values."""
    hi, lo, valid = kmer_windows(codes, k, DNA_BITS)
    rhi, rlo = reverse_complement(hi, lo, k)
    fwd_smaller = (hi < rhi) | ((hi == rhi) & (lo <= rlo))
    return torch.where(fwd_smaller, hi, rhi), torch.where(fwd_smaller, lo, rlo), valid
