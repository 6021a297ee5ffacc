"""ingest.submit_host_s: the host wall of the program's `sketch.pieces` and
`sketch.fill` spans (cutting genomes into rows, filling each launch
group's u8 row buffer) over the window, per Gbase ingested."""

from portbench.program_trace import per_gbase, span


def read(r):
    pieces, fill = span(r, "sketch.pieces", "wall_s"), span(r, "sketch.fill", "wall_s")
    return per_gbase(r, pieces + fill) if pieces is not None and fill is not None else None
