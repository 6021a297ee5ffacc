"""The arithmetic of the per-layer metrics on given work and times."""

import os
import sys
from types import SimpleNamespace

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import readers, run, trace  # noqa: E402

PEAKS = run.load_json(run.HERE + "/peaks.json")["NVIDIA H100 80GB HBM3"]


def _rec(**t):
    base = {"spans": {}, "span_calls": {}, "int_mm": [], "k2": [], "busy_s": 0.0, "window_s": 1.0,
            "device_events": 1}
    base.update(t)
    return SimpleNamespace(kind="search", trace=base, peaks=PEAKS)


def test_peaks_are_the_data_sheet_figures():
    assert PEAKS["int8_ops_s"] == 1.979e15 and PEAKS["hbm_bytes_s"] == 3.35e12


def test_int_mm_roofline_takes_the_larger_bound_of_each_call():
    ops = 3.23e12                       # a 1,021-row chunk at 65,703 x 24,000
    nbytes = 1.0e9
    t_ops = ops / 1.979e15              # 1.632 ms, ops-bound
    small = (2 * 8 * 65703 * 24000, 1.58e9)  # 8 rows: bytes-bound, 0.4716 ms
    t_small = small[1] / 3.35e12
    r = _rec(int_mm=[(2 * t_ops, ops, nbytes), (2 * t_small, *small)])
    assert readers.int_mm_roofline(r) == pytest.approx(50.0)
    assert readers.int_mm_bound_s(r.trace["int_mm"], PEAKS) == pytest.approx(t_ops + t_small)


def test_k2_roofline_counts_distinct_rows_once():
    # 1,024 x 160 ids over 6,144 lanes, 50,000 distinct rows
    nbytes = 4 * (50000 * 6144 + 1024 * 6144 + 2 * 1024 * 160)
    assert readers.k2_bytes(6144, 1024, 160, 50000) == nbytes
    r = _rec(k2=[(4 * nbytes / 3.35e12, 6144, 1024, 160, 50000)])
    assert readers.k2_roofline(r) == pytest.approx(25.0)


def test_readers_leave_out_what_they_cannot_read():
    assert readers.int_mm_roofline(_rec()) is None
    assert readers.k2_roofline(SimpleNamespace(kind="search", trace=_rec().trace, peaks=None)) is None
    assert readers.idle_percent(_rec(device_events=0)) is None
    assert readers.host_ms(SimpleNamespace(kind="search", trace=None)) is None


def test_idle_and_host_ms():
    r = _rec(busy_s=0.25, window_s=2.0, spans={"search": 3.0, "search_device": 1.0},
             span_calls={"search": 100})
    assert readers.idle_percent(r) == pytest.approx(87.5)
    assert readers.host_ms(r) == pytest.approx(20.0)


def test_busy_union_and_named_gaps():
    dev = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0), (9.5, 12.0)]
    busy, gaps = trace.busy_and_gaps(dev, 0.0, 10.0)
    assert busy == pytest.approx(2.0 + 1.0 + 0.5)
    assert gaps == [(0.0, 1.0), (3.0, 5.0), (6.0, 9.5)]
    spans = [(0.0, 10.0, "search"), (2.5, 5.5, "host_rescore"), (7.0, 9.0, "upload")]
    named = trace.name_gaps(gaps, spans)
    # each gap goes to the innermost span open at its midpoint
    assert named == [["upload", 3.5], ["host_rescore", 2.0], ["search", 1.0]]
    assert trace.name_gaps([(10.5, 11.0)], spans) == [["window", 0.5]]


def test_top_ops_sums_by_name_within_the_window():
    ev = [(0.0, 1.0, "a"), (2.0, 4.0, "b"), (3.0, 3.5, "a"), (9.0, 11.0, "c")]
    assert trace.top_ops(ev, 0.5, 10.0) == [["b", 2.0], ["a", 1.0], ["c", 1.0]]
