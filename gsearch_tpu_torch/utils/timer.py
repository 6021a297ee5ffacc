"""Per-stage wall/CPU timers.

The reference instruments every pipeline stage with wall + CPU time and RSS
snapshots (reference: src/utils/files.rs:270-315, src/dna/dnasketch.rs:466-476).
StageTimer is the structured equivalent; `report()` returns a dict suitable
for logging or for processing_state.json enrichment.  Each stage is also a
`pipeline.<name>` span of utils/trace.py, so a profiler session sees it.
"""

import threading
import time
from contextlib import contextmanager

from . import trace


class StageTimer:
    """Thread-safe: stages may run concurrently (producer-thread parse
    overlaps device sketch), so per-stage wall sums can legitimately
    exceed the end-to-end wall clock.  cpu_s is the CPU time of the thread
    that ran each stage."""

    def __init__(self):
        self._wall = {}
        self._cpu = {}
        self._counts = {}
        self._lock = threading.Lock()

    @contextmanager
    def stage(self, name: str):
        span = "pipeline." + name
        w0 = time.perf_counter()
        c0 = time.thread_time()
        try:
            with trace.span(span):
                yield
        finally:
            dw = time.perf_counter() - w0
            dc = time.thread_time() - c0
            trace.cpu(span, dc)
            with self._lock:
                self._wall[name] = self._wall.get(name, 0.0) + dw
                self._cpu[name] = self._cpu.get(name, 0.0) + dc
                self._counts[name] = self._counts.get(name, 0) + 1

    def report(self) -> dict:
        return {
            name: {
                "wall_s": round(self._wall[name], 4),
                "cpu_s": round(self._cpu.get(name, 0.0), 4),
                "calls": self._counts[name],
            }
            for name in self._wall
        }
