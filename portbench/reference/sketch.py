"""A plain OptDens sketcher: FASTA -> codes -> canonical k-mers -> darts ->
windowed pre-reduce -> per-slot minimum -> optimal densification.

It follows gsearch's one-permutation hashing in block mode (every record
of a file one genome, records joined by one invalid code), with the hash
constants, the row partition and the race of the published definition
that the program and its JAX reference share:

- a k-mer is the 2-bit code of k bases (A C G T = 0 1 2 3, the first base
  in the top bits), canonical as the smaller of it and its reverse
  complement; a window holding any other symbol throws no dart;
- a dart lands in slot mix2(kmer, seed ^ SLOT) % S and carries the word
  (mix2(kmer, seed ^ KEY) with its low slot_bits cleared) | slot;
- a genome longer than the largest block (2^22) is cut into pieces that
  overlap by k - 1 bases, each start a multiple of 4; each piece is a row
  of the largest block, or of its own block bucket when some piece holds
  more than 1,024 invalid positions;
- in a row whose length passes the gate (a multiple of 32, and half of it
  at least 40 darts a slot), each window of 32 positions keeps only its 6
  smallest distinct words before the race;
- a slot keeps its least word; empty slots are filled over 32 rounds of
  probes into originally occupied slots, then by a genome-dependent
  filler; the signature is the word's top 24 bits as an f32 in [0, 1).

Everything is plain torch on int64 holding u32 values; no function of the
program is imported.  `round_bf16` gives the control's signatures.

As an ingest cell's reference (a configuration's `reference`, this one
where it names none) the module declares the `ALGO` and the `DATA` it
sketches, and gives `read_genome`, `sketch` (the program's f32 signature)
and `control`.
"""

from __future__ import annotations

import gzip
from typing import List, Tuple

import numpy as np
import torch

ALGO = "optdens"
DATA = ("DNA",)

M32 = 0xFFFFFFFF
SEED = 0x5EED
SLOT_SEED = 0x0BADF00D
KEY_SEED = 0x5CA1AB1E
DENS_FAMILY = 0x0D15EA5E
FILLER_SEED = 0xDEADBEEF
DENS_ROUNDS = 32
MIN_BLOCK_LOG2, MAX_BLOCK_LOG2 = 14, 22
MAX_INVALID = 1024
WINDOW, KEEP = 32, 6

_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _LUT[_c] = _i
    _LUT[_c + 32] = _i  # lower case
_LUT[ord("U")] = _LUT[ord("u")] = 3


def read_genome(path: str) -> np.ndarray:
    """A FASTA file (gzip by suffix) as one code row: kept records joined
    by one invalid code; records whose header holds "capsid" are skipped."""
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


def block_length(n: int, max_log2: int = MAX_BLOCK_LOG2) -> int:
    """Smallest bucket >= n among 2^14, 1.5 x 2^14, 2^15, ... up to 2^max_log2."""
    nb, cap = 1 << MIN_BLOCK_LOG2, 1 << max_log2
    while nb < n and nb < cap:
        if n <= nb + (nb >> 1) <= cap:
            return nb + (nb >> 1)
        nb <<= 1
    return min(nb, cap)


def pieces(codes: np.ndarray, k: int, max_log2: int | None = None) -> List[Tuple[np.ndarray, int]]:
    """The rows a genome is raced in: [(codes, row length)]."""
    max_log2 = MAX_BLOCK_LOG2 if max_log2 is None else max_log2
    max_block, n = 1 << max_log2, len(codes)
    if n <= max_block:
        return [(codes, block_length(n, max_log2))]
    step = max_block - (k - 1)
    step -= step % 4
    parts = [codes[st : st + max_block] for st in range(0, n, step)]
    heavy = any(int(np.count_nonzero(p > 3)) > MAX_INVALID for p in parts)
    return [(p, block_length(len(p), max_log2) if heavy else max_block) for p in parts]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    return ((((x * (c >> 16)) & 0xFFFF) << 16) + x * (c & 0xFFFF)) & M32


def mix32(x: torch.Tensor, seed) -> torch.Tensor:
    """lowbias32 of (x ^ seed), u32 in int64."""
    x = (x ^ seed) & M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def mix2(hi: torch.Tensor, lo: torch.Tensor, seed: int) -> torch.Tensor:
    a = mix32(lo, seed ^ 0x9E3779B9)
    b = mix32(hi ^ a, seed)
    return mix32(a ^ b, seed ^ 0x85EBCA6B)


def _canonical(row: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hi, lo, valid) of the canonical k-mer starting at each position."""
    n = row.shape[0]
    c = torch.cat([row.to(torch.int64), torch.full((k,), 255, dtype=torch.int64, device=row.device)])
    valid = torch.ones(n, dtype=torch.bool, device=row.device)
    fwd = torch.zeros(n, dtype=torch.int64, device=row.device)
    rev = torch.zeros(n, dtype=torch.int64, device=row.device)
    for j in range(k):
        cj = c[j : j + n]
        valid &= cj < 4
        cj = cj & 3
        fwd = (fwd << 2) | cj              # base j at bits 2(k-1-j)
        rev = rev | ((3 - cj) << (2 * j))  # its complement, mirrored
    lo_mask = (1 << min(2 * k, 32)) - 1
    f_hi, f_lo = fwd >> 32, fwd & lo_mask
    r_hi, r_lo = rev >> 32, rev & lo_mask
    fwd_smaller = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo <= r_lo))
    return torch.where(fwd_smaller, f_hi, r_hi), torch.where(fwd_smaller, f_lo, r_lo), valid


def _row_race(row: torch.Tensor, k: int, s: int, seed: int) -> torch.Tensor:
    """One row's per-slot least word [s] (M32 where no dart)."""
    slot_bits = max(1, s.bit_length())
    low = (1 << slot_bits) - 1
    hi, lo, valid = _canonical(row, k)
    slot = mix2(hi, lo, seed ^ SLOT_SEED) % s
    key = mix2(hi, lo, seed ^ KEY_SEED)
    words = torch.where(valid, (key & (M32 ^ low)) | slot, M32)
    n = words.shape[0]
    if n % WINDOW == 0 and (n // 2) / s >= 40:
        w = torch.sort(words.reshape(-1, WINDOW), dim=1).values
        dup = torch.zeros_like(w, dtype=torch.bool)
        dup[:, 1:] = w[:, 1:] == w[:, :-1]
        words = torch.sort(torch.where(dup, M32, w), dim=1).values[:, :KEEP].reshape(-1)
    out = torch.full((1 << slot_bits,), M32, dtype=torch.int64, device=row.device)
    out.scatter_reduce_(0, words & low, words, reduce="amin")
    return out[:s]


def sketch_words(codes: np.ndarray, *, k: int, s: int, device, seed: int = SEED,
                 max_log2: int | None = None) -> torch.Tensor:
    """A genome's densified slot words, u32 in int64 [s]."""
    word = torch.full((s,), M32, dtype=torch.int64, device=device)
    for piece, nb in pieces(codes, k, max_log2):
        row = torch.full((nb,), 255, dtype=torch.uint8, device=device)
        row[: len(piece)] = torch.from_numpy(np.ascontiguousarray(piece)).to(device)
        word = torch.minimum(word, _row_race(row, k, s, seed))
    found = word != M32
    idx = torch.arange(s, dtype=torch.int64, device=device)
    key = torch.where(found, word, 0)
    out, empty = key, ~found
    for r in range(DENS_ROUNDS):
        tgt = mix32(idx, seed ^ DENS_FAMILY ^ (r * 0x9E37)) % s
        out = torch.where(empty & found[tgt], key[tgt], out)
        empty = empty & ~found[tgt]
    least = torch.where(found, word, M32).min()
    return torch.where(empty, mix32(idx ^ least, seed ^ FILLER_SEED), out)


def sketch(codes: np.ndarray, *, k: int, s: int, device, seed: int = SEED,
           max_log2: int | None = None) -> np.ndarray:
    """A genome's f32 signature [s]: the word's top 24 bits over 2^24."""
    words = sketch_words(codes, k=k, s=s, device=device, seed=seed, max_log2=max_log2)
    return ((words >> 8).to(torch.float32) * (1.0 / (1 << 24))).cpu().numpy()


def round_bf16(sig: np.ndarray) -> np.ndarray:
    """The control: f32 signatures carried in bfloat16, the next precision
    below the stated one."""
    return torch.from_numpy(sig).to(torch.bfloat16).to(torch.float32).numpy()


control = round_bf16
