"""ingest.prob_darts_s: the device time of the program's `sketch.prob.runs`
(run starts and multiplicities) and `sketch.prob.arrivals` (ProbMinHash's
draws, slots, times and payloads) spans over the window, per Gbase ingested;
None where either span is absent."""

from portbench.program_trace import per_gbase, span


def read(r):
    runs, arrivals = span(r, "sketch.prob.runs", "device_s"), span(r, "sketch.prob.arrivals", "device_s")
    return per_gbase(r, None if runs is None or arrivals is None else runs + arrivals)
