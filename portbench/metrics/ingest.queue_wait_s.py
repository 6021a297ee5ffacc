"""ingest.queue_wait_s: the host wall of the program's `ingest.queue_wait`
span (the sketching thread waiting for the next parsed file) over the
window, per Gbase ingested."""

from portbench.program_trace import per_gbase, span


def read(r):
    return per_gbase(r, span(r, "ingest.queue_wait", "wall_s"))
