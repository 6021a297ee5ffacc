"""gsearch_tpu_torch packed race against gsearch_tpu: race words bit-exact on
ungated shapes and on shapes where the windowed pre-reduce is gated on."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsearch_tpu.ops import race as jrace
from gsearch_tpu_torch.ops import race as trace


def _darts(rng, shape, s, dup_rate=0.0):
    slots = rng.integers(0, s, size=shape).astype(np.int32)
    keys = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    if dup_rate:  # repeated darts (tandem-repeat k-mers) inside windows
        dup = rng.random(shape) < dup_rate
        slots[..., 1:][dup[..., 1:]] = slots[..., :-1][dup[..., 1:]]
        keys[..., 1:][dup[..., 1:]] = keys[..., :-1][dup[..., 1:]]
    valid = rng.random(shape) > 0.1
    return slots, keys, valid


def _same_race(j, t):
    np.testing.assert_array_equal(np.asarray(j.found), t.found.numpy())
    np.testing.assert_array_equal(np.asarray(j.key).astype(np.int64), t.key.numpy())
    np.testing.assert_array_equal(np.asarray(j.payload).astype(np.int64), t.payload.numpy())


@pytest.mark.parametrize("shape,s,gated", [
    ((2, 4096), 300, False),
    ((3, 1 << 14), 1024, False),
    ((4100,), 100, False),          # n % 32 != 0: never gated
    ((2, 8192), 64, True),
    ((1 << 16,), 512, True),
    ((2, 1 << 14), 128, True),
])
@pytest.mark.parametrize("use_valid", [True, False])
def test_packed_race_bit_exact(rng, shape, s, gated, use_valid):
    assert trace.prereduce_gated(shape[-1], s) is gated
    slots, keys, valid = _darts(rng, shape, s, dup_rate=0.2)
    if not use_valid:
        slots[..., ::7] = s  # out-of-range slots are dropped like invalid darts
    jv = jnp.asarray(valid) if use_valid else None
    tv = torch.from_numpy(valid) if use_valid else None
    j = jrace.bucket_min_packed(jnp.asarray(slots), jnp.asarray(keys), s, valid=jv)
    t = trace.bucket_min_packed(torch.from_numpy(slots.astype(np.int64)),
                                torch.from_numpy(keys.astype(np.int64)), s, valid=tv)
    _same_race(j, t)
    _same(jrace.sketch_fingerprint(j), trace.sketch_fingerprint(t))


def _same(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


def test_combine_and_empty_race_bit_exact(rng):
    s = 200
    parts = []
    for _ in range(2):
        slots, keys, valid = _darts(rng, (3, 1000), s)
        parts.append((slots, keys, valid))
    j = [jrace.bucket_min_packed(jnp.asarray(a), jnp.asarray(b), s, valid=jnp.asarray(c)) for a, b, c in parts]
    t = [trace.bucket_min_packed(torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64)),
                                 s, valid=torch.from_numpy(c)) for a, b, c in parts]
    _same_race(jrace.combine_race(j[0], j[1]), trace.combine_race(t[0], t[1]))
    je, te = jrace.empty_race((3,), s), trace.empty_race((3,), s, torch.device("cpu"))
    _same_race(je, te)
    _same_race(jrace.combine_race(je, j[1]), trace.combine_race(te, t[1]))
    _same_race(jrace.combine_race(j[0], je), trace.combine_race(t[0], te))
