"""ingest.upload_s: the device time of the program's `sketch.upload` spans
(each launch group's rows and ids copied to the card) over the window, per
Gbase ingested.  The device time, not the host wall: a pageable copy waits
behind the stream's earlier kernels, so the wall holds that wait too."""

from portbench.program_trace import per_gbase, span


def read(r):
    return per_gbase(r, span(r, "sketch.upload", "device_s"))
