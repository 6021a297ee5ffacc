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


# ---- the exact race with payload, and the packed race that carries one ----------

def _same_where_found(j, t):
    """found equal on every slot; key and payload equal where found (the
    reference leaves both undefined elsewhere, the port writes M32 and 0)."""
    found = np.asarray(j.found)
    np.testing.assert_array_equal(found, t.found.numpy())
    np.testing.assert_array_equal(np.asarray(j.key).astype(np.int64)[found], t.key.numpy()[found])
    np.testing.assert_array_equal(np.asarray(j.payload).astype(np.int64)[found], t.payload.numpy()[found])
    assert (t.key.numpy()[~found] == 0xFFFFFFFF).all() and (t.payload.numpy()[~found] == 0).all()


def _i64(x):
    return torch.from_numpy(x.astype(np.int64))


@pytest.mark.parametrize("shape,s", [((700,), 64), ((3, 900), 50), ((2, 2, 300), 37), ((1, 40), 300)])
@pytest.mark.parametrize("use_payload", [True, False])
@pytest.mark.parametrize("use_valid", [True, False])
def test_bucket_min_matches_reference(rng, shape, s, use_payload, use_valid):
    """Few distinct keys, so slots tie in key and the payload decides;
    s = 300 over 40 darts leaves most slots empty; batch dimensions."""
    slots, keys, valid = _darts(rng, shape, s)
    keys = (keys % 5).astype(np.uint32) * np.uint32(0x33333333)  # ties, keys past 2^31
    keys[..., :3] = [0, 0xFFFFFFFF, 0x80000000]
    pay = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    pay[..., :3] = [0xFFFFFFFF, 0xFFFFFFFF, 0]
    j = jrace.bucket_min(jnp.asarray(slots), jnp.asarray(keys), s,
                         payload=jnp.asarray(pay) if use_payload else None,
                         valid=jnp.asarray(valid) if use_valid else None)
    t = trace.bucket_min(_i64(slots), _i64(keys), s, payload=_i64(pay) if use_payload else None,
                         valid=torch.from_numpy(valid) if use_valid else None)
    _same_where_found(j, t)
    if not use_payload:  # the key stands in for the payload
        np.testing.assert_array_equal(t.key.numpy()[t.found.numpy()], t.payload.numpy()[t.found.numpy()])


def test_bucket_min_all_invalid_and_max_dart(rng):
    s = 20
    slots, keys, _ = _darts(rng, (2, 100), s)
    none = np.zeros((2, 100), bool)
    j = jrace.bucket_min(jnp.asarray(slots), jnp.asarray(keys), s, valid=jnp.asarray(none))
    t = trace.bucket_min(_i64(slots), _i64(keys), s, valid=torch.from_numpy(none))
    assert not t.found.any()
    _same_where_found(j, t)
    _same_race(jrace.empty_race((2,), s)._replace(payload=jnp.zeros((2, s), jnp.uint32)),
               trace.RaceResult(t.found, t.key, t.payload))
    # a dart of the greatest key and payload is still found
    one = trace.bucket_min(torch.tensor([3]), torch.tensor([0xFFFFFFFF]), s,
                           payload=torch.tensor([0xFFFFFFFF]))
    assert one.found.tolist() == [i == 3 for i in range(s)]
    assert int(one.key[3]) == 0xFFFFFFFF and int(one.payload[3]) == 0xFFFFFFFF


def test_combine_race_of_halves_equals_the_whole(rng):
    s = 80
    slots, keys, valid = _darts(rng, (3, 2000), s)
    keys = keys % 7
    pay = rng.integers(0, 2**32, size=slots.shape, dtype=np.uint64).astype(np.uint32)
    args = [_i64(slots), _i64(keys), _i64(pay), torch.from_numpy(valid)]
    whole = trace.bucket_min(args[0], args[1], s, payload=args[2], valid=args[3])
    halves = [trace.bucket_min(a[..., h], k[..., h], s, payload=p[..., h], valid=v[..., h])
              for a, k, p, v in [args] for h in (slice(0, 1000), slice(1000, 2000))]
    merged = trace.combine_race(*halves)
    for a, b in zip(whole, merged):
        assert torch.equal(a, b)
    jh = [jrace.bucket_min(jnp.asarray(slots[..., h]), jnp.asarray(keys[..., h]), s,
                           payload=jnp.asarray(pay[..., h]), valid=jnp.asarray(valid[..., h]))
          for h in (slice(0, 1000), slice(1000, 2000))]
    _same_where_found(jrace.combine_race(*jh), merged)


@pytest.mark.parametrize("shape,s,gated", [((3, 4096), 300, False), ((2, 8192), 64, True),
                                           ((1 << 15,), 128, True)])
@pytest.mark.parametrize("use_valid", [True, False])
def test_packed_payload_race_bit_exact(rng, shape, s, gated, use_valid):
    assert trace.prereduce_gated(shape[-1], s) is gated
    slots, keys, valid = _darts(rng, shape, s, dup_rate=0.2)
    pay = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    if not use_valid:
        slots[..., ::7] = s
    j = jrace.bucket_min_packed_payload(jnp.asarray(slots), jnp.asarray(keys), jnp.asarray(pay), s,
                                        valid=jnp.asarray(valid) if use_valid else None)
    t = trace.bucket_min_packed_payload(_i64(slots), _i64(keys), _i64(pay), s,
                                        valid=torch.from_numpy(valid) if use_valid else None)
    _same_race(j, t)
