"""The card's idle gaps in one benchmark cell's window, named by the
program's innermost span (gsearch_tpu_torch/utils/trace.py) open on the
main thread at each gap.

    python3 scripts/trace_gaps.py --workload <cell> --seed <n> --seconds <s> [--out FILE]

Sets the cell up as `python3 -m portbench.run` does, runs its window under
`portbench.trace.Tracer` (torch.profiler with CPU and CUDA activities), and
prints: the busy and idle seconds of the card over the window; the idle
seconds by innermost `gs:` span of the main thread (by
`portbench.trace.busy_and_gaps` and `name_gaps`), beside those by the
tracer's own outside spans; and the program's spans and counters over the
window (`trace.snapshot`, device times from the profiler's trace by
`portbench.program_trace`) and the per-layer metrics that read them, with
the tracer's `_int_mm` and K2 event totals to compare them with.  --out also writes all of it as JSON.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PROGRAM_PREFIX = "gs:"


def program_gaps(prof, top: int = 20) -> dict:
    """Busy and idle seconds of the card within the tracer's window, and
    the idle seconds by the innermost program span open on the window's
    thread, from the profiler's raw events."""
    from portbench.trace import SPAN_PREFIX, busy_and_gaps, name_gaps

    device_iv, spans, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a, b = e.start_ns() / 1e9, e.end_ns() / 1e9
        if str(e.device_type()).endswith("CUDA"):
            if not (name.startswith((SPAN_PREFIX, PROGRAM_PREFIX)) or e.is_user_annotation()):
                device_iv.append((a, b))
        elif name == SPAN_PREFIX + "window":
            window = (a, b, e.start_thread_id())
        elif name.startswith(PROGRAM_PREFIX):
            spans.append((a, b, name[len(PROGRAM_PREFIX):], e.start_thread_id()))
    if window is None:
        raise RuntimeError("the profiler recorded no window annotation")
    w0, w1, main = window
    busy, gaps = busy_and_gaps(device_iv, w0, w1)
    main_spans = [(a, b, n) for a, b, n, th in spans if th == main]
    return {"window_s": w1 - w0, "busy_s": busy, "idle_s": sum(b - a for a, b in gaps),
            "gaps": len(gaps), "program_spans_main": len(main_spans),
            "idle_by_program_span": name_gaps(gaps, main_spans, top=top)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None, help="also write the result as JSON here")
    args = ap.parse_args(argv)

    import torch

    from gsearch_tpu_torch.utils import trace
    from portbench import drivers, program_trace, run
    from portbench.trace import Tracer

    if not torch.cuda.is_available():
        print("trace_gaps needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    files = run.cell_files(run.spec(), args.workload)
    kind = files.traffic["kind"]
    driver = drivers.DRIVERS[kind](files.cfg, files.traffic, args.seed, device)
    t0 = time.perf_counter()
    driver.setup()
    torch.cuda.synchronize(device)
    print(f"card: {run.card_line()}; cell {args.workload}, seed {args.seed}, set-up "
          f"{time.perf_counter() - t0:.3f} s")
    trace.snapshot(reset=True)
    tracer = Tracer(device, kind)
    with tracer:
        rec = driver.window(args.seconds, tracer)
    t = rec.trace = tracer.readings
    missed: dict = {}
    program = rec.program_trace = program_trace.with_device_times(trace.snapshot(reset=True), tracer, missed)
    readings = {m["name"]: run.reader(m["name"])(rec) for m in run.metrics_of(run.spec(), args.workload, True)
                if m["source"].startswith("program_")}
    out = {"cell": args.workload, "seed": args.seed, "batches": rec.batches, "failed": rec.failed,
           "bases": getattr(rec, "bases", None), **program_gaps(tracer._prof),
           "idle_by_outside_span": t["idle_gaps"], "outside_spans": t["spans"],
           "outside_span_calls": t["span_calls"],
           "int_mm_events_s": sum(c[0] for c in t["int_mm"]), "int_mm_calls": len(t["int_mm"]),
           "k2_events_s": sum(c[0] for c in t["k2"]), "k2_calls": len(t["k2"]),
           "program_metrics": readings, "device_ops_without_launch": missed, "program": program}
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
