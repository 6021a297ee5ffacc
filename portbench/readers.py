"""Arithmetic shared by the metric readers in metrics/.  Each reader takes
the run's record and returns a number, or None where the run has nothing
to read: the harness then leaves the metric out of the result line."""

from __future__ import annotations


def host_ms(r):
    t = r.trace
    if t is None or r.kind != "search" or not t["span_calls"].get("search"):
        return None
    return (t["spans"]["search"] - t["spans"].get("search_device", 0.0)) / t["span_calls"]["search"] * 1e3


def int_mm_bound_s(calls, peaks) -> float:
    """Least seconds of _int_mm calls [(seconds, ops, bytes)]."""
    return sum(max(ops / peaks["int8_ops_s"], nb / peaks["hbm_bytes_s"]) for _, ops, nb in calls)


def k2_bytes(lanes: int, qc: int, r: int, distinct: int) -> int:
    """K2's bytes: the distinct referenced rows, the query lanes, the ids and
    the output, each read or written once (int32 lanes, f32 output)."""
    return 4 * (distinct * lanes + qc * lanes + 2 * qc * r)


def int_mm_roofline(r):
    t, peaks = r.trace, r.peaks
    if t is None or peaks is None or not t["int_mm"]:
        return None
    spent = sum(s for s, _, _ in t["int_mm"])
    return 100.0 * int_mm_bound_s(t["int_mm"], peaks) / spent if spent > 0 else None


def k2_roofline(r):
    t, peaks = r.trace, r.peaks
    if t is None or peaks is None or not t["k2"]:
        return None
    spent = sum(c[0] for c in t["k2"])
    need = sum(k2_bytes(*c[1:]) for c in t["k2"]) / peaks["hbm_bytes_s"]
    return 100.0 * need / spent if spent > 0 else None


def idle_percent(r):
    t = r.trace
    if t is None or not t.get("device_events") or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
