"""ingest.prob_sort_s: the device time of the program's `sketch.prob.sort`
spans (ProbMinHash's int64 sort of each row's k-mers) over the window, per
Gbase (residues, for an amino-acid corpus) ingested."""

from portbench.program_trace import per_gbase, span


def read(r):
    return per_gbase(r, span(r, "sketch.prob.sort", "device_s"))
