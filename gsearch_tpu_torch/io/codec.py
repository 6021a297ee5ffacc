"""Host sequence codecs: ASCII FASTA bytes -> uint8 codes (the port's copy
of gsearch_tpu/io/codec.py).

DNA encodes to 0..3 (A C G T, U as T), protein to 0..19; every other byte
(N, ambiguity codes, separators) becomes DNA_INVALID, a hard k-mer break.
`PackedCodes` is the 2-bit form the native parser writes for DNA in
one-block mode.
"""

from __future__ import annotations

import numpy as np

DNA_INVALID = np.uint8(255)

# DNA: A=0 C=1 G=2 T=3 so that complement(x) == 3 - x == ~x & 3
_DNA_TABLE = np.full(256, DNA_INVALID, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _DNA_TABLE[ord(_c)] = _i
    _DNA_TABLE[ord(_c.lower())] = _i
_DNA_TABLE[ord("U")] = 3  # RNA
_DNA_TABLE[ord("u")] = 3

AA_ALPHABET = "ACDEFGHIKLMNPQRSTVWY"
_AA_TABLE = np.full(256, DNA_INVALID, dtype=np.uint8)
for _i, _c in enumerate(AA_ALPHABET):
    _AA_TABLE[ord(_c)] = _i
    _AA_TABLE[ord(_c.lower())] = _i


def encode_dna(seq_bytes: bytes | np.ndarray) -> np.ndarray:
    """ASCII DNA -> uint8 codes in {0..3} with 255 for invalid symbols."""
    arr = np.frombuffer(seq_bytes, dtype=np.uint8) if isinstance(seq_bytes, (bytes, bytearray)) else seq_bytes
    return _DNA_TABLE[arr]


def encode_aa(seq_bytes: bytes | np.ndarray) -> np.ndarray:
    """ASCII protein -> uint8 codes in {0..19} with 255 for invalid symbols."""
    arr = np.frombuffer(seq_bytes, dtype=np.uint8) if isinstance(seq_bytes, (bytes, bytearray)) else seq_bytes
    return _AA_TABLE[arr]


class PackedCodes:
    """A DNA code row as 2-bit-packed codes (4 a byte) plus the sorted
    positions of its invalid codes (record separators, Ns)."""

    __slots__ = ("p2", "n", "inv")

    def __init__(self, p2: np.ndarray, n: int, inv: np.ndarray):
        self.p2 = p2       # uint8 [>= ceil(n/4)]
        self.n = int(n)    # codes in the row, separators included
        self.inv = inv     # int32 sorted positions of invalid codes

    def __len__(self) -> int:
        return self.n

    def to_codes(self) -> np.ndarray:
        """Unpack to one uint8 code a base."""
        m = (self.n + 3) // 4
        b = self.p2[:m]
        c = np.empty(4 * m, np.uint8)
        c[0::4] = b & 3
        c[1::4] = (b >> 2) & 3
        c[2::4] = (b >> 4) & 3
        c[3::4] = (b >> 6) & 3
        c = c[: self.n]
        c[self.inv[self.inv < self.n]] = DNA_INVALID
        return c

    def piece(self, start: int, length: int) -> "PackedCodes":
        """Zero-copy slice [start, start+length); start must be a multiple
        of 4 so the byte view stays aligned."""
        assert start % 4 == 0
        end = min(start + length, self.n)
        inv = self.inv[(self.inv >= start) & (self.inv < end)]
        return PackedCodes(
            self.p2[start // 4 : (end + 3) // 4], end - start,
            (inv - start).astype(np.int32),
        )
