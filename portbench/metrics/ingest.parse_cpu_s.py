"""ingest.parse_cpu_s: the CPU time of the parse threads in the program's
`pipeline.parse` spans (each thread's own, summed) over the window, per
Gbase ingested."""

from portbench.program_trace import per_gbase, span


def read(r):
    return per_gbase(r, span(r, "pipeline.parse", "cpu_s"))
