"""A plain ProbMinHash sketcher on amino acids: FASTA -> residue codes ->
5-bit k-mers -> multiplicities -> three arrivals a distinct k-mer -> per-slot
minimum -> u32 fingerprints.

It follows the published definition that the program and its JAX reference
share (ProbMinHash, Ertl 2020, algorithm 3a as gsearch runs it), in block
mode (every record of a file one proteome, records joined by one invalid
code):

- residues ACDEFGHIKLMNPQRSTVWY, in either case, are codes 0-19; anything
  else (X, `*`, the record separator) is invalid;
- a k-mer is the k codes at 5 bits each, the first residue in the top bits,
  as (hi, lo) = its top and low 32 bits; there is no reverse complement.  A
  window holding an invalid code throws no dart;
- a proteome longer than 2^23 codes is cut into pieces of 2^23 whose starts
  lie 2^23 - (k - 1) apart, so every window lies in exactly one piece; the
  multiplicities are counted per piece;
- each distinct k-mer x of a piece, of multiplicity m, throws ARRIVALS
  darts: the j-th lands in slot mix2(x, s_j ^ SLOT) % S at time
  (E_0 + ... + E_j) * (1 / m), with s_j = seed ^ RANK ^ (j * 0x9E3779B9)
  and E_i = -log(u_i) for u_i = ((mix2(x, s_i) >> 8) + 1) / 2^24; the log
  is taken in float64 and rounded to f32, the sums, the reciprocal and the
  product are f32; every dart carries the payload mix2(x, seed ^ PAY);
- a slot keeps the dart with the least (time, payload), times compared as
  f32; pieces merge by the same rule;
- an empty slot gets mix32(slot ^ f, seed ^ FILLER), f the proteome's least
  winning time bits (2^32 - 1 when no slot is found);
- the signature is each slot's payload (or filler), u32.

Departures from the program's form: the multiplicities come from
`torch.unique` over each piece's valid k-mers (the program sorts the padded
row and reads run starts by a cummax and a reversed cummin), and a piece is
not padded to a block bucket, since padding throws no dart.

Everything is plain torch on int64 holding u32 values; the hash mixers are
the OptDens reference's (`reference/sketch.py`); no function of the program
is imported.  As an ingest cell's reference it declares `ALGO` and `DATA`
and gives `read_genome`, `sketch` and `control` (each slot's low 16 bits
cleared: a 16-bit fingerprint, the next width below the stated one).
"""

from __future__ import annotations

import gzip
from typing import List

import numpy as np
import torch

from .sketch import M32, mix2, mix32

ALGO = "prob"
DATA = ("AA",)

SEED = 0x5EED
RANK_SEED = 0xA11CE5
SLOT_SEED = 0xB0B5EED
PAY_SEED = 0xCAFEF00D
FILLER_SEED = 0xD00DF00D
ARRIVALS = 3
MAX_BLOCK_LOG2 = 23
BITS = 5

_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACDEFGHIKLMNPQRSTVWY"):
    _LUT[_c] = _i
    _LUT[_c + 32] = _i  # lower case


def read_genome(path: str) -> np.ndarray:
    """A protein FASTA file (gzip by suffix) as one code row: kept records
    joined by one invalid code; records whose header holds "capsid" are
    skipped."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    parts: List[np.ndarray] = []
    start = data.find(b">")
    for chunk in data[start + 1 :].split(b"\n>") if start >= 0 else []:
        nl = chunk.find(b"\n")
        if nl < 0 or b"capsid" in chunk[:nl]:
            continue
        seq = chunk[nl + 1 :].replace(b"\n", b"").replace(b"\r", b"")
        if parts:
            parts.append(np.array([255], np.uint8))
        parts.append(_LUT[np.frombuffer(seq, np.uint8)])
    return np.concatenate(parts) if parts else np.empty(0, np.uint8)


def pieces(codes: np.ndarray, k: int) -> List[np.ndarray]:
    """The pieces a proteome is counted and raced in."""
    block = 1 << MAX_BLOCK_LOG2
    if len(codes) <= block:
        return [codes]
    return [codes[st : st + block] for st in range(0, len(codes), block - (k - 1))]


def kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """The valid k-mers of a code row as 5k-bit integers (int64), in row order."""
    n = codes.shape[0] - k + 1
    if n <= 0:
        return torch.empty(0, dtype=torch.int64, device=codes.device)
    c = codes.to(torch.int64)
    value = torch.zeros(n, dtype=torch.int64, device=codes.device)
    valid = torch.ones(n, dtype=torch.bool, device=codes.device)
    for j in range(k):
        cj = c[j : j + n]
        valid &= cj < 20
        value = (value << BITS) | (cj & 31)
    return value[valid]


def multiplicities(x: torch.Tensor):
    """(distinct k-mers, how often each occurs)."""
    return torch.unique(x, return_counts=True)


def exp1(h: torch.Tensor) -> torch.Tensor:
    """u32 hash bits -> an Exp(1) draw in f32: the log of a uniform in
    (0, 1] taken in float64 and rounded to f32."""
    u = ((h >> 8).to(torch.float32) + 1.0) * (1.0 / (1 << 24))
    return -torch.log(u.to(torch.float64)).to(torch.float32)


def race(x: torch.Tensor, m: torch.Tensor, s: int, seed: int) -> torch.Tensor:
    """One piece's per-slot least (time bits << 32 | payload) [s], int64
    (the int64 maximum where no dart landed)."""
    hi, lo = x >> 32, x & M32
    inv_m = 1.0 / m.to(torch.float32)
    payload = mix2(hi, lo, seed ^ PAY_SEED)
    out = torch.full((s,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=x.device)
    t = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(ARRIVALS):
        sub = (seed ^ RANK_SEED ^ (j * 0x9E3779B9)) & M32
        t = t + exp1(mix2(hi, lo, sub))
        slot = mix2(hi, lo, sub ^ SLOT_SEED) % s
        # a positive f32's bits order as the float does
        time_bits = (t * inv_m).view(torch.int32).to(torch.int64)
        out.scatter_reduce_(0, slot, (time_bits << 32) | payload, reduce="amin")
    return out


def sketch(codes: np.ndarray, *, k: int, s: int, device, seed: int = SEED) -> np.ndarray:
    """A proteome's u32 signature [s], the program's signature dtype."""
    best = torch.full((s,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=device)
    for piece in pieces(codes, k):
        row = torch.from_numpy(np.ascontiguousarray(piece)).to(device)
        x, m = multiplicities(kmers(row, k))
        best = torch.minimum(best, race(x, m, s, seed))
    found = best != torch.iinfo(torch.int64).max
    least = torch.where(found, best >> 32, M32).min()
    idx = torch.arange(s, dtype=torch.int64, device=device)
    sig = torch.where(found, best & M32, mix32(idx ^ least, seed ^ FILLER_SEED))
    return sig.cpu().numpy().astype(np.uint32)


def control(sigs: np.ndarray) -> np.ndarray:
    """The control: each slot's low 16 bits cleared."""
    return sigs & np.uint32(0xFFFF0000)
