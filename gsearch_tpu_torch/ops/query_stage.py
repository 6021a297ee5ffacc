"""A query batch from the caller's host array to the device, with no host
copy of the whole batch.

    stager = QueryStager(device)          # one per searcher or index
    q_dev = stager.rows(queries, qb)      # [qb, S] int32 on the device

Rows 0..nq-1 of the result are `sig_bits` of the caller's rows: f32, u32
and i32 go up as bit patterns (NaN payloads and -0.0 survive: nothing
passes through a float conversion), u16 is widened by value.  Pad rows
nq..qb-1 are all-ones bits (-1), filled on the device, as the reference
pads a query batch.

A batch that spans several chunks of CHUNK_BYTES goes up, on a CUDA
device, through page-locked slots allocated at the first such batch: its
chunks are split into COPY_THREADS contiguous runs, one a worker (the
calling thread is one of them), and each worker alternates between its
own SLOTS slots: it copies a chunk's rows into a free slot (numpy's copy,
which releases the interpreter lock), copies the slot to its rows of the
device tensor with `non_blocking=True` on the caller's current stream,
and records an event after that copy, which the slot's next fill waits
for.  So the host copies run in parallel, each overlapping the DMA of the
chunk before it, and the pinned memory a stager holds is COPY_THREADS x
SLOTS x CHUNK_BYTES whatever the batch size.  A batch of one chunk has
nothing to overlap: it goes up in one plain copy, the driver's own staged
copy, which costs it less (as on a CPU device, or where page-locked
memory is refused).

Spans: `search.stage` (the device tensor, its pad fill, the slots' first
allocation), `search.upload` (the copies).  Counters: `search.stage_chunks`
(chunks sent through the slots), `search.stage_direct` (batches sent by
the plain copy).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..utils import trace
from .distance import sig_bits

#: bytes of one page-locked slot (whole rows; a row longer than this
#: takes a slot of its own length)
CHUNK_BYTES = 4 << 20
#: slots each worker alternates between
SLOTS = 2
#: workers a batch's chunks are split over, the calling thread included
COPY_THREADS = 4


class QueryStager:
    """Sends query batches to one device; holds the page-locked slots and
    the copy workers.  Safe to share between threads (a batch holds the
    slots while it is sent)."""

    def __init__(self, device: torch.device, *, _ring_on_cpu: bool = False):
        """_ring_on_cpu sends batches for a CPU device through the slots,
        unpinned (the tests' way to run the chunking without a card)."""
        self.device = device
        self._ring = device.type == "cuda" or _ring_on_cpu
        self._slots: list | None = None   # per worker, SLOTS flat int32 host tensors
        self._events: list | None = None  # per worker, the event after each slot's last copy
        self._pool: ThreadPoolExecutor | None = None
        self._lock = threading.Lock()

    def rows(self, queries: np.ndarray, qb: int | None = None) -> torch.Tensor:
        """queries [nq, S] host rows (f32, u32, i32 or u16) -> [qb, S] int32
        on the device (qb defaults to nq; pad rows -1)."""
        nq, s = queries.shape
        qb = nq if qb is None else qb
        if qb < nq:
            raise ValueError(f"qb={qb} is smaller than the batch's {nq} rows")
        src = queries if queries.dtype == np.uint16 else sig_bits(queries)
        per = _chunk_rows(s)
        dev = self.device
        with self._lock:
            with trace.span("search.stage", dev):
                out = torch.empty((qb, s), dtype=torch.int32, device=dev)
                if qb > nq:
                    out[nq:].fill_(-1)
                ring = self._ring and nq > per and self._ready(s)
            with trace.span("search.upload", dev):
                if ring:
                    self._send(src, out, per)
                    trace.count("search.stage_chunks", -(-nq // per))
                elif nq:
                    out[:nq].copy_(torch.from_numpy(np.ascontiguousarray(sig_bits(queries))))
                    trace.count("search.stage_direct", 1)
        return out

    def _ready(self, s: int) -> bool:
        """Whether the slots hold at least one row of width s, allocating
        them (again, if a wider row came) as needed; False where page-locked
        memory is refused."""
        if self._slots is not None and self._slots[0][0].numel() >= _chunk_rows(s) * s:
            return True
        elems = max(CHUNK_BYTES // 4, s)
        pin = self.device.type == "cuda"
        try:
            self._slots = [[torch.empty(elems, dtype=torch.int32, pin_memory=pin) for _ in range(SLOTS)]
                           for _ in range(COPY_THREADS)]
        except RuntimeError:  # no page-locked memory to be had
            self._ring = False
            self._slots = None
            return False
        self._events = [[torch.cuda.Event() if pin else None for _ in range(SLOTS)]
                        for _ in range(COPY_THREADS)]
        if COPY_THREADS > 1 and self._pool is None:
            self._pool = ThreadPoolExecutor(COPY_THREADS - 1, thread_name_prefix="gsearch-stage")
        return True

    def _send(self, src: np.ndarray, out: torch.Tensor, per: int) -> None:
        """Rows of src into out[:nq], chunks of per rows, the chunks split
        into contiguous runs over the workers."""
        starts = list(range(0, src.shape[0], per))
        parts = min(COPY_THREADS, len(starts))
        cut = [len(starts) * w // parts for w in range(parts + 1)]
        stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        runs = [(w, starts[cut[w] : cut[w + 1]], per, src, out, stream) for w in range(parts)]
        futs = [self._pool.submit(self._run, *r) for r in runs[1:]]
        try:
            self._run(*runs[0])
        finally:
            for f in futs:
                f.result()

    def _run(self, w: int, starts: list, per: int, src: np.ndarray, out: torch.Tensor,
             stream) -> None:
        """Worker w's chunks through its slots, its copies on `stream`."""
        nq, s = src.shape
        slots, events = self._slots[w], self._events[w]
        with torch.cuda.stream(stream):  # no-op for None (a CPU device)
            for i, r0 in enumerate(starts):
                r1 = min(r0 + per, nq)
                ev = events[i % len(slots)]
                if ev is not None:
                    ev.synchronize()  # the slot's previous copy has completed
                slot = slots[i % len(slots)][: (r1 - r0) * s].view(r1 - r0, s)
                np.copyto(slot.numpy(), src[r0:r1])
                out[r0:r1].copy_(slot, non_blocking=True)
                if ev is not None:
                    ev.record(stream)


def _chunk_rows(s: int) -> int:
    """Rows of width s a slot holds."""
    return max(1, CHUNK_BYTES // 4 // s)
