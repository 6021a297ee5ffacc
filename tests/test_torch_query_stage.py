"""gsearch_tpu_torch's query stager (ops/query_stage.py): the device rows a
batch goes up as equal `sig_bits` of the caller's rows bit for bit (f32
NaN payloads and -0.0, u32 and i32 patterns at or above 2^31, u16 at or
above 2^15 widened by value), pad rows are -1, and a smaller batch after a
larger one leaves no stale row; through the slots and their workers
(unpinned on the CPU, page-locked on a card) with chunks that split the
batch evenly or leave a short last chunk, the plain copy (a CPU device, a
batch of one chunk or less), and the plain copy where page-locked memory
is refused; `search.stage_chunks` counts the chunks sent through the
slots and `search.stage_direct` the batches sent by the plain copy.

The file imports no JAX, so on a card its CUDA cases run with
`python -m pytest tests/test_torch_query_stage.py -m cuda -q --noconftest`."""

import numpy as np
import pytest
import torch

from gsearch_tpu_torch.ops import query_stage
from gsearch_tpu_torch.ops.distance import sig_bits
from gsearch_tpu_torch.ops.mxu import _next_pow2
from gsearch_tpu_torch.utils import trace

DTYPES = {"f32": np.float32, "u32": np.uint32, "i32": np.int32, "u16": np.uint16}
NQS = [1, 5, 8, 1000, 1024, 1025]
WIDTHS = [12000, 1023]
# f32 bit patterns a float conversion would not keep: -0.0, quiet and
# signalling NaNs with payloads, a negative NaN, the infinities
_SPECIAL = np.array([0x80000000, 0x7FC00001, 0x7F800001, 0xFFC12345, 0x7FBFFFFF,
                     0x7F800000, 0xFF800000], dtype=np.uint32)


def _batch(rng, dtype, nq, s):
    if dtype == np.uint16:
        return rng.integers(0, 1 << 16, size=(nq, s), dtype=np.uint16)
    bits = rng.integers(0, 1 << 32, size=(nq, s), dtype=np.uint32)
    bits[:, : len(_SPECIAL)] = _SPECIAL
    return bits.view(dtype)


def _chunk_rows(nq: int, chunking: str) -> int:
    """Rows a chunk holds: a divisor of nq (no short chunk) or not."""
    if chunking == "even":
        return max(d for d in range(1, max(1, nq // 2) + 1) if nq % d == 0)
    return max(2, nq // 3 + 1)


def _cases():
    for name, dtype in DTYPES.items():
        for nq in NQS:
            for s in WIDTHS:
                for chunking in ("even", "short"):
                    yield pytest.param("ring", dtype, nq, s, chunking,
                                       id=f"ring-{name}-{nq}x{s}-{chunking}")
                yield pytest.param("direct", dtype, nq, s, None, id=f"direct-{name}-{nq}x{s}")
                yield pytest.param("cuda", dtype, nq, s, None, id=f"cuda-{name}-{nq}x{s}",
                                   marks=pytest.mark.cuda)
            yield pytest.param("refused", dtype, nq, 1023, "short", id=f"refused-{name}-{nq}x1023")


@pytest.fixture(autouse=True)
def fresh_record():
    trace.disable()
    trace.snapshot(reset=True)
    yield
    trace.disable()
    trace.snapshot(reset=True)


@pytest.mark.parametrize("path,dtype,nq,s,chunking", list(_cases()))
def test_stager_sends_sig_bits(monkeypatch, path, dtype, nq, s, chunking):
    device = torch.device("cpu")
    if path == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the slots are page-locked there")
        device = torch.device("cuda", 0)
    per = None
    if chunking is not None:
        per = _chunk_rows(nq, chunking)
        monkeypatch.setattr(query_stage, "CHUNK_BYTES", per * s * 4)
    elif path == "cuda":
        per = max(1, query_stage.CHUNK_BYTES // 4 // s)
    if path == "refused":
        real_empty = torch.empty

        def refuse(*args, **kw):
            if "pin_memory" in kw:
                raise RuntimeError("page-locked memory refused")
            return real_empty(*args, **kw)

        monkeypatch.setattr(query_stage.torch, "empty", refuse)
    stager = query_stage.QueryStager(device, _ring_on_cpu=path in ("ring", "refused"))
    refused = path == "refused" and nq > per  # the first batch asks for slots
    if path == "refused":
        per = None  # every batch falls back to the plain copy

    rng = np.random.default_rng(nq * 7919 + s)
    chunks = direct = 0
    trace.enable()
    for rows in (_batch(rng, dtype, nq, s), _batch(rng, dtype, max(1, nq // 3), s)):
        n = rows.shape[0]
        qb = _next_pow2(n, floor=8)
        got = stager.rows(rows, qb)
        assert got.dtype == torch.int32 and got.device.type == device.type
        assert tuple(got.shape) == (qb, s)
        got = got.cpu().numpy()
        np.testing.assert_array_equal(got[:n], sig_bits(rows))
        assert (got[n:] == -1).all()
        # a batch of one chunk or less goes up in one plain copy
        if per is not None and n > per:
            chunks += -(-n // per)
        else:
            direct += 1
    if refused:
        assert stager._slots is None and not stager._ring
    counters = trace.snapshot()["counters"]
    assert counters.get("search.stage_chunks", 0) == chunks
    assert counters.get("search.stage_direct", 0) == direct
