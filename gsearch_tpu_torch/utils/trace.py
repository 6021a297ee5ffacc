"""Spans and counters inside the program, on while a torch profiler session
is active or after `enable()`.

    with trace.span("search.upload", device):   # device: where the work runs
        q = q.to(device)
    trace.count("search.queries", q.shape[0])

Off (no profiler, no `enable()`), `span` returns one shared null context
and `count` returns at once: nothing is allocated, timed or recorded.  On,
a span
  - sums its host wall (`perf_counter_ns`) and its calls under its name,
    in sums the thread keeps for itself (no lock on the way) and
    `snapshot` merges; `cpu` adds CPU time a caller measured itself;
  - under a profiler session, opens `record_function("gs:<name>")`, so the
    profiler's trace shows the span beside the kernels and copies it
    launches, and its device time is read from that trace;
  - after `enable()`, on a CUDA device, also records a timing event pair on
    the current stream at entry and exit.  The pair is read at `snapshot`,
    or folded into the sums once its end has completed when more than
    FOLD_AT pairs wait: a span never synchronises.  Folded events are kept
    for reuse, since creating one costs more than recording it.  A profiler
    session alone records no pairs: the profiler has the device times
    already, and a pair's host cost would land in the traced work.
A counter adds a host integer; it never reads the device.

"On" reads the profiler's process-wide flag as well as the calling
thread's, so threads the session did not start (the parse workers) record
too; their `gs:` annotations reach the profiler's trace only where it
records that thread.
"""

from __future__ import annotations

import collections
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "gs:"
#: event pairs a thread keeps waiting before it folds the completed ones
FOLD_AT = 1024

_enabled = False
_thread_profiler_on = torch._C._autograd._profiler_enabled
_local = threading.local()
_lock = threading.Lock()
_threads: list = []       # [(thread, _Sums)] of every thread that recorded
_launch_base: dict = {}   # cuda_lib.launches at the last reset


def on() -> bool:
    return _enabled or _autograd_profiler._is_profiler_enabled or _thread_profiler_on()


class _Null:
    """The span of tracing off.  Its methods are builtins, so a with
    statement on it runs no Python frame (half the off-cost of methods
    written in Python): __enter__ returns 0, __exit__ returns "", which
    is false, so an exception propagates."""

    __slots__ = ()
    __enter__ = int
    __exit__ = "".format


_NULL = _Null()


class _Sums:
    """One thread's sums: spans {name: [calls, wall_ns, cpu_s or None,
    device_ms or None]}, counters {name: n}, its unread event pairs (name,
    device index, start, end), and by device index its current stream as
    last seen and its folded events."""

    __slots__ = ("spans", "counters", "pending", "streams", "free")

    def __init__(self):
        self.spans: dict = {}
        self.counters: dict = {}
        self.pending: collections.deque = collections.deque()
        self.streams: dict = {}
        self.free: dict = {}

    def stream(self, device: torch.device):
        """(device index, current stream) of a CUDA device, without
        building a new Stream object while the current one is unchanged."""
        idx = torch._C._cuda_getDevice() if device.index is None else device.index
        st = self.streams.get(idx)
        if st is None or torch._C._cuda_getCurrentStream(idx)[0] != st.stream_id:
            st = self.streams[idx] = torch.cuda.current_stream(idx)
        return idx, st

    def event(self, idx: int):
        free = self.free.get(idx)
        return free.pop() if free else torch.cuda.Event(enable_timing=True)


def _sums() -> _Sums:
    s = getattr(_local, "sums", None)
    if s is None:
        s = _local.sums = _Sums()
        with _lock:
            _threads.append((threading.current_thread(), s))
    return s


def _fold(s: _Sums, wait: bool) -> None:
    """Add the device time of s's event pairs, oldest first; without wait,
    stop at the first pair whose end has not completed."""
    while s.pending:
        name, idx, start, end = s.pending[0]
        if wait:
            end.synchronize()
        elif not end.query():
            return
        s.pending.popleft()
        row = s.spans[name]
        row[3] = (row[3] or 0.0) + start.elapsed_time(end)
        s.free.setdefault(idx, []).extend((start, end))


class _Span:
    __slots__ = ("name", "device", "sums", "idx", "stream", "rf", "start", "w0")

    def __init__(self, name: str, device):
        self.name = name
        # event pairs after enable() only: under a profiler alone the trace
        # holds the span's device time
        self.device = device if _enabled and device is not None and device.type == "cuda" else None

    def __enter__(self):
        self.sums = s = _sums()
        self.rf = None
        if _autograd_profiler._is_profiler_enabled or _thread_profiler_on():
            self.rf = _autograd_profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        if self.device is not None:
            self.idx, self.stream = s.stream(self.device)
            self.start = s.event(self.idx)
            self.start.record(self.stream)
        self.w0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter_ns() - self.w0
        s = self.sums
        if self.device is not None:
            end = s.event(self.idx)
            end.record(self.stream)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        row = _row(s, self.name)
        row[0] += 1
        row[1] += wall
        if self.device is not None:
            s.pending.append((self.name, self.idx, self.start, end))
            if len(s.pending) > FOLD_AT:
                _fold(s, wait=False)
        return False


def _row(s: _Sums, name: str) -> list:
    row = s.spans.get(name)
    if row is None:
        row = s.spans[name] = [0, 0, None, None]
    return row


def span(name: str, device: torch.device | None = None):
    """A context that times the work under `name` when tracing is on;
    after `enable()`, with a CUDA `device`, also the device's time between
    its entry and exit on that device's current stream (under a profiler
    alone the profiler's trace holds it)."""
    # the test of on() inlined: it is all a span costs when off
    if not (_enabled or _autograd_profiler._is_profiler_enabled or _thread_profiler_on()):
        return _NULL
    return _Span(name, device)


def cpu(name: str, seconds: float) -> None:
    """Add CPU seconds the caller measured (its own thread's) to span
    `name` when tracing is on."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled or _thread_profiler_on()):
        return
    row = _row(_sums(), name)
    row[2] = (row[2] or 0.0) + seconds


def count(name: str, n: int) -> None:
    """Add the host integer n to counter `name` when tracing is on."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled or _thread_profiler_on()):
        return
    c = _sums().counters
    c[name] = c.get(name, 0) + int(n)


def _launches() -> dict:
    from ..ops import cuda_lib

    return dict(cuda_lib.launches)


def _reset() -> None:
    global _launch_base
    with _lock:
        _threads[:] = [(t, s) for t, s in _threads if t.is_alive()]
        for _, s in _threads:
            s.spans.clear()
            s.counters.clear()
            s.pending.clear()
    _launch_base = _launches()


def enable() -> None:
    """Turn tracing on without a profiler, from an empty record."""
    global _enabled
    _reset()
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def snapshot(reset: bool = False) -> dict:
    """Every thread's sums merged: {"spans": {name: {"calls", "wall_s",
    "cpu_s", "device_s"}}, "counters": {name: n}, "launches": {kernel: n}},
    where cpu_s is None for a span no caller gave CPU time, device_s None
    for one that recorded no event pair (off the card, or under a profiler
    alone), and launches are those of `ops.cuda_lib.launches` since the
    last reset or `enable()`.  Waits for the spans' device events; spans still
    running in other threads may be missed."""
    with _lock:
        threads = [s for _, s in _threads]
    spans: dict = {}
    counters: dict = {}
    for s in threads:
        _fold(s, wait=True)
        for name, (calls, wall, cpu, dev) in list(s.spans.items()):
            out = spans.setdefault(name, {"calls": 0, "wall_s": 0.0, "cpu_s": None, "device_s": None})
            out["calls"] += calls
            out["wall_s"] += wall / 1e9
            if cpu is not None:
                out["cpu_s"] = (out["cpu_s"] or 0.0) + cpu
            if dev is not None:
                out["device_s"] = (out["device_s"] or 0.0) + dev / 1e3
        for name, n in list(s.counters.items()):
            counters[name] = counters.get(name, 0) + n
    now = _launches()
    launches = {k: v - _launch_base.get(k, 0) if v >= _launch_base.get(k, 0) else v
                for k, v in now.items()}
    if reset:
        _reset()
    return {"spans": spans, "counters": counters, "launches": launches}
