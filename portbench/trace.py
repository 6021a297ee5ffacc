"""What a `--trace 1` run records, from the benchmark's side only.

`Tracer` wraps calls into the program's layers for the length of the
window and restores them after it:

- host spans (`span`, and the wrappers below) add up their seconds on the
  host clock and open a `torch.profiler.record_function("pb:<name>")`
  annotation, so the device's idle gaps can be named by the span that was
  open on the main thread;
- the outermost `search_device` of a search (the flat searcher's or the
  graph index's) synchronises the device on entry and exit, so that span
  holds the device part of a search and the rest of the `search` span is
  host work (staging, copies, the host re-score);
- `torch._int_mm` and K2 (`gather_hamming` as the searcher and the graph
  index call it) are timed with CUDA events around each call, with the
  work each call needs: `_int_mm`'s operations over the real rows and its
  bytes, K2's bytes over the unique rows its ids reference;
- `torch.profiler` (CPU and CUDA activities) runs over the window; its
  device events give the busy time, the device operations that took most
  time and the idle gaps.

On the CPU (the tests) CUDA events are replaced by the host clock and the
profiler sees no device: the device readings are then absent.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

SPAN_PREFIX = "pb:"


class _Patch:
    def __init__(self):
        self._undo = []

    def set(self, owner, name: str, value) -> None:
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def restore(self) -> None:
        for owner, name, value in reversed(self._undo):
            setattr(owner, name, value)
        self._undo.clear()


class _Clock:
    """CUDA event pairs on a card, the host clock elsewhere."""

    def __init__(self, cuda: bool):
        self.cuda = cuda

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, start):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return (start, ev)
        return (start, time.perf_counter())

    def seconds(self, pair) -> float:
        a, b = pair
        if self.cuda:
            return a.elapsed_time(b) / 1e3
        return b - a


def _distinct_valid(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Number of distinct ids in [0, n), as a device scalar (no sync)."""
    v = ids.reshape(-1).to(torch.int64)
    v = torch.sort(torch.where((v >= 0) & (v < n), v, -1)).values
    distinct = 1 + (v[1:] != v[:-1]).sum()
    return distinct - (v[0] < 0).to(distinct.dtype)


class Tracer:
    def __init__(self, device: torch.device, kind: str):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.kind = kind
        self.spans: dict = defaultdict(float)
        self.span_calls: dict = defaultdict(int)
        self.int_mm: list = []   # (event pair, ops, bytes)
        self.k2: list = []       # (event pair, lanes, qc, r, distinct device scalar)
        self._clock = _Clock(self.cuda)
        self._patch = _Patch()
        self._depth = 0
        self._pending_ops = None
        self._prof = None
        self.readings = None

    # ---- spans ---------------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(SPAN_PREFIX + name):
            try:
                yield
            finally:
                self.spans[name] += time.perf_counter() - t0
                self.span_calls[name] += 1

    def _spanned(self, name: str, fn):
        tracer = self

        def wrapper(*args, **kwargs):
            with tracer.span(name):
                return fn(*args, **kwargs)
        return wrapper

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _outer_device(self, fn):
        """The outermost search_device of a search, synchronised on both ends."""
        tracer = self

        def wrapper(*args, **kwargs):
            if tracer._depth:
                tracer._depth += 1
                try:
                    return fn(*args, **kwargs)
                finally:
                    tracer._depth -= 1
            tracer._sync()
            tracer._depth = 1
            try:
                with tracer.span("search_device"):
                    out = fn(*args, **kwargs)
                    tracer._sync()
            finally:
                tracer._depth = 0
            return out
        return wrapper

    def _top_scores(self, fn):
        tracer = self

        def wrapper(searcher, q, k):
            rows = q.shape[0]
            width = searcher.m * searcher.s
            # real rows only: what the query rows and the database rows need
            tracer._pending_ops = (2 * rows * searcher.n * width,
                                   rows * width + searcher.n * width + 4 * rows * searcher.n)
            try:
                return fn(searcher, q, k)
            finally:
                tracer._pending_ops = None
        return wrapper

    def _int_mm(self, fn):
        tracer = self

        def wrapper(a, b):
            start = tracer._clock.start()
            out = fn(a, b)
            pair = tracer._clock.stop(start)
            ops, nbytes = tracer._pending_ops or (2 * a.shape[0] * a.shape[1] * b.shape[1],
                                                  a.numel() + b.numel() + 4 * a.shape[0] * b.shape[1])
            tracer.int_mm.append((pair, ops, nbytes))
            return out
        return wrapper

    def _k2(self, fn):
        tracer = self

        def wrapper(db, q, ids, **kwargs):
            start = tracer._clock.start()
            out = fn(db, q, ids, **kwargs)
            pair = tracer._clock.stop(start)
            tracer.k2.append((pair, db.shape[1], ids.shape[0], ids.shape[1],
                              _distinct_valid(ids, db.shape[0])))
            return out
        return wrapper

    def _install(self) -> None:
        import gsearch_tpu_torch.index.hnsw as hnsw
        import gsearch_tpu_torch.ops.mxu as mxu
        import gsearch_tpu_torch.pipeline as pipeline
        from gsearch_tpu_torch.index.flat import FlatIndex
        from gsearch_tpu_torch.models.base import SketcherBase

        p = self._patch
        if self.kind == "search":
            p.set(mxu.MxuSearcher, "search_device", self._outer_device(mxu.MxuSearcher.search_device))
            p.set(hnsw.HnswIndex, "search_device", self._outer_device(hnsw.HnswIndex.search_device))
            p.set(hnsw.HnswIndex, "_host_distances",
                  self._spanned("host_rescore", hnsw.HnswIndex._host_distances))
            p.set(mxu.MxuSearcher, "_top_scores", self._top_scores(mxu.MxuSearcher._top_scores))
            p.set(torch, "_int_mm", self._int_mm(torch._int_mm))
            for mod in (mxu, hnsw):
                p.set(mod, "gather_hamming", self._k2(mod.gather_hamming))
        else:
            p.set(pipeline, "_sketch_dir", self._spanned("sketch_dir", pipeline._sketch_dir))
            p.set(pipeline, "dumpall", self._spanned("dump", pipeline.dumpall))
            p.set(FlatIndex, "insert", self._spanned("index_insert", FlatIndex.insert))
            p.set(SketcherBase, "sketch_submit",
                  self._spanned("sketch_submit", SketcherBase.sketch_submit))
            p.set(SketcherBase, "sketch_finish",
                  self._spanned("sketch_finish", SketcherBase.sketch_finish))

    # ---- the window ----------------------------------------------------------

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._install()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._window = torch.profiler.record_function(SPAN_PREFIX + "window")
        self._window.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._sync()
            self._window.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
        finally:
            self._patch.restore()
        if exc[0] is None:
            self.readings = self._reduce()
        return False

    # ---- reduction -----------------------------------------------------------

    def _reduce(self) -> dict:
        out = {
            "spans": dict(self.spans),
            "span_calls": dict(self.span_calls),
            "int_mm": [(self._clock.seconds(p), ops, nb) for p, ops, nb in self.int_mm],
            "k2": [(self._clock.seconds(p), lanes, qc, r, int(d)) for p, lanes, qc, r, d in self.k2],
        }
        out.update(reduce_profile(self._prof))
        return out


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def busy_and_gaps(device_iv, w0: float, w1: float):
    """(busy seconds, idle gaps [(start, end)]) of device intervals within [w0, w1]."""
    busy, gaps, t = 0.0, [], w0
    for a, b in _merge((max(a, w0), min(b, w1)) for a, b in device_iv if b > w0 and a < w1):
        if a > t:
            gaps.append((t, a))
        busy += b - a
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    return busy, gaps


def name_gaps(gaps, spans, top: int = 10):
    """Idle seconds by the innermost span open at each gap's midpoint
    ("window" where none is), the `top` largest, descending.  spans:
    [(start, end, name)] of one thread, properly nested."""
    points = [((a + b) / 2, 1, i) for i, (a, b) in enumerate(gaps)]
    marks = [(s, 0, j) for j, (s, _, _) in enumerate(spans)] + [(e, 2, j) for j, (_, e, _) in enumerate(spans)]
    totals: dict = defaultdict(float)
    stack: list = []
    for t, what, i in sorted(points + marks):
        if what == 0:
            stack.append(i)
        elif what == 2:
            if i in stack:
                stack.remove(i)
        else:
            a, b = gaps[i]
            totals[spans[stack[-1]][2] if stack else "window"] += b - a
    return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:top]


def top_ops(device_ev, w0: float, w1: float, top: int = 10):
    totals: dict = defaultdict(float)
    for a, b, name in device_ev:
        if b > w0 and a < w1:
            totals[name[:160]] += min(b, w1) - max(a, w0)
    return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:top]


def reduce_profile(prof) -> dict:
    """Device busy seconds, the traced window, the device operations that
    took most time and the idle gaps by host span, from the profiler's
    raw events (seconds on the profiler's clock)."""
    device_ev, spans, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a, b = e.start_ns() / 1e9, e.end_ns() / 1e9
        if str(e.device_type()).endswith("CUDA"):
            if not (name.startswith(SPAN_PREFIX) or e.is_user_annotation()):
                device_ev.append((a, b, name))
        elif name.startswith(SPAN_PREFIX):
            if name == SPAN_PREFIX + "window":
                window = (a, b, e.start_thread_id())
            else:
                spans.append((a, b, name[len(SPAN_PREFIX):], e.start_thread_id()))
    if window is None:
        raise RuntimeError("the profiler recorded no window annotation")
    w0, w1, main = window
    busy, gaps = busy_and_gaps([(a, b) for a, b, _ in device_ev], w0, w1)
    main_spans = [(a, b, n) for a, b, n, th in spans if th == main]
    return {"busy_s": busy, "window_s": w1 - w0, "device_events": len(device_ev),
            "device_ops": top_ops(device_ev, w0, w1), "idle_gaps": name_gaps(gaps, main_spans)}
