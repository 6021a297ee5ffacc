"""32-bit hash mixers and uniform / exponential draws on torch tensors.

Counterpart of gsearch_tpu/ops/hash.py, bit-exact with it except for the
logarithm of `exp_from_bits` (see `log_f32`).  CPU torch has
no uint32 shifts, compares or minimum, so every u32 value of the port
rides in an int64 tensor holding 0..2^32-1 ("u32 carrier").  Products are
split into 16-bit halves so no intermediate leaves the int64 range: the
low 32 bits of the result are the wrapped u32 product.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Signature bits as a u32 carrier: f32 by bit pattern, ints widened."""
    if x.dtype == torch.float32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for a u32 carrier x and a constant c < 2^32."""
    return ((((x * (c >> 16)) & 0xFFFF) << 16) + x * (c & 0xFFFF)) & M32


def mix32(x: torch.Tensor, seed: int | torch.Tensor = 0) -> torch.Tensor:
    """lowbias32 finalizer of (x ^ seed); u32 -> u32, bijective in x."""
    x = (x ^ seed) & M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def mix2(hi: torch.Tensor, lo: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Mix a (hi, lo) u32 pair (a logical u64) into one u32."""
    seed &= M32
    a = mix32(lo, seed ^ 0x9E3779B9)
    b = mix32(hi ^ a, seed)
    return mix32(a ^ b, seed ^ 0x85EBCA6B)


def uniform01(h: torch.Tensor) -> torch.Tensor:
    """u32 hash bits -> f32 uniform in [0, 1) (24-bit mantissa path).
    The product of an integer below 2^24 and 2^-24 is exact in f32."""
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of f32 values, computed in float64 and rounded to f32.
    An f32 log differs by an ulp between back ends (XLA, torch on the CPU,
    CUDA's logf) on several percent of inputs; a float64 log is within an
    ulp of double on each, so its f32 rounding is the correctly rounded
    value almost always and the port's CPU and CUDA paths agree."""
    return torch.log(x.to(torch.float64)).to(torch.float32)


def exp_from_bits(h: torch.Tensor) -> torch.Tensor:
    """u32 hash bits -> f32 Exp(1) draw; uses (0, 1] to avoid log(0).  The
    uniform is exact (an integer <= 2^24 times 2^-24); only the log can
    differ from the reference's, by an ulp."""
    u = ((h >> 8).to(torch.float32) + 1.0) * (1.0 / (1 << 24))
    return -log_f32(u)
