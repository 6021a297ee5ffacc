"""The program's own spans and counters (gsearch_tpu_torch/utils/trace.py)
over a traced window, for the readers in metrics/.

The program records while a torch profiler session is active, and the
tracer's profiler covers the window alone, so the program's record after
the window is the window's.  The first reader of a run takes it (emptying
the program's record) and keeps it on the run's record.  A run that saw
no device, or a program without that module, gives None: the metric is
then left out.

Under a profiler alone the program times its spans on the host and marks
them in the profiler's trace as `gs:<name>` annotations; their device time
is read here from that trace.  A device operation belongs to every span
open on the window's thread when the host call that launched it ran (the
CUDA runtime or driver call with the operation's correlation id, else the
torch operator it is linked to); a span's
device time is the stretch from the first start to the last end of its
operations, summed over its calls.  Device work is launched by the
window's thread: the ingest pipeline's parse threads launch none.  The
harness hands a reader the run's readings alone; the profiler they came
from is held by the run's tracer, which the helper finds up the call stack
by its readings."""

from __future__ import annotations

import sys

PROGRAM_PREFIX = "gs:"
_UNREAD = object()


def _on_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _is_launch(name: str) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernel,
    cudaMemcpyAsync, ...), not a torch operator."""
    return name.startswith("cu") and "::" not in name


def device_seconds(events, thread, missed: dict | None = None) -> dict:
    """{span name: device seconds} of the `gs:` spans that `thread` opened,
    from a profiler's raw events (kineto's: name, device_type,
    is_user_annotation, correlation_id, linked_correlation_id, start_ns,
    end_ns, start_thread_id).  A device operation is placed at the host
    call with its correlation id, else at the torch operator or annotation
    its linked id names.  missed, where given, counts by name the device
    operations placed at neither."""
    launched, host, ops, spans = {}, {}, [], []
    for e in events:
        name = e.name()
        if _on_device(e):
            if not e.is_user_annotation():
                ops.append((e.correlation_id(), e.linked_correlation_id(), e.start_ns(), e.end_ns(), name))
        elif _is_launch(name):
            launched[e.correlation_id()] = e.start_ns()
        else:
            host[e.correlation_id()] = e.start_ns()
            if e.is_user_annotation() and name.startswith(PROGRAM_PREFIX) and e.start_thread_id() == thread:
                spans.append((e.start_ns(), e.end_ns(), name[len(PROGRAM_PREFIX):]))
    marks = [(a, 0, i) for i, (a, _, _) in enumerate(spans)]
    marks += [(b, 2, i) for i, (_, b, _) in enumerate(spans)]
    for corr, linked, a, b, name in ops:
        t = launched.get(corr, host.get(linked) if linked else None)
        if t is not None:
            marks.append((t, 1, (a, b)))
        elif missed is not None:
            missed[name[:80]] = missed.get(name[:80], 0) + 1
    marks.sort(key=lambda m: (m[0], m[1]))
    first, last = [None] * len(spans), [None] * len(spans)
    opened: list = []
    for _, what, x in marks:
        if what == 0:
            opened.append(x)
        elif what == 2:
            opened.remove(x)
        else:
            a, b = x
            for i in opened:
                if first[i] is None or a < first[i]:
                    first[i] = a
                if last[i] is None or b > last[i]:
                    last[i] = b
    out: dict = {}
    for (_, _, name), a, b in zip(spans, first, last):
        if a is not None:
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out


def tracer_device_seconds(tracer, missed: dict | None = None):
    """device_seconds of a finished portbench.trace.Tracer's window, on the
    thread that opened the window; None without one."""
    from portbench.trace import SPAN_PREFIX

    prof = getattr(tracer, "_prof", None)
    if prof is None:
        return None
    events = prof.profiler.kineto_results.events()
    thread = next((e.start_thread_id() for e in events
                   if not _on_device(e) and e.name() == SPAN_PREFIX + "window"), None)
    return None if thread is None else device_seconds(events, thread, missed)


def with_device_times(snap: dict, tracer, missed: dict | None = None) -> dict:
    """The program's snapshot with each span's device time from the
    tracer's profiler where the program recorded none (no event pairs).
    Where the trace cannot be read, the device times stay None (their
    metrics are left out) and snap["device_times_error"] says why."""
    try:
        dev = tracer_device_seconds(tracer, missed) if tracer is not None else None
    except Exception as exc:  # a reader must not fail the run
        snap["device_times_error"] = repr(exc)
        dev = None
    for name, seconds in (dev or {}).items():
        row = snap["spans"].get(name)
        if row is not None and row["device_s"] is None:
            row["device_s"] = seconds
    return snap


def _tracer_of(r):
    """The tracer whose readings are r.trace, from the callers' frames."""
    from portbench.trace import Tracer

    f = sys._getframe(1)
    while f is not None:
        for v in list(f.f_locals.values()):
            if isinstance(v, Tracer) and v.readings is r.trace:
                return v
        f = f.f_back
    return None


def record(r):
    """{"spans": {name: {"calls", "wall_s", "cpu_s", "device_s"}},
    "counters": {...}, "launches": {...}} of the run's window, or None."""
    t = r.trace
    if t is None or not t.get("device_events"):
        return None
    snap = getattr(r, "program_trace", _UNREAD)
    if snap is _UNREAD:
        try:
            from gsearch_tpu_torch.utils import trace
        except ImportError:
            snap = None
        else:
            snap = with_device_times(trace.snapshot(reset=True), _tracer_of(r))
        r.program_trace = snap
    return snap


def span(r, name: str, field: str):
    """One field of a span over the window ("calls", "wall_s", "cpu_s",
    "device_s"), or None where the span or the field is absent."""
    snap = record(r)
    row = None if snap is None else snap["spans"].get(name)
    return None if row is None else row[field]


def counter(r, name: str):
    snap = record(r)
    return None if snap is None else snap["counters"].get(name)


def per_search_ms(r, name: str, field: str):
    """A span's seconds (field) over the window per search call, in ms."""
    calls, value = span(r, "search", "calls"), span(r, name, field)
    return value / calls * 1e3 if calls and value is not None else None


def per_gbase(r, seconds):
    """Seconds over the window per Gbase ingested."""
    if seconds is None or r.kind != "ingest" or not r.bases:
        return None
    return seconds / (r.bases / 1e9)
