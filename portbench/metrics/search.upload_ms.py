"""search.upload_ms (also search.upload_ms.small, which moves
request_p95_ms): the device time of the program's `search.upload` span
(the queries' copy to the card, pageable) over the window, per call of
the index's search, in ms."""

from portbench.program_trace import per_search_ms


def read(r):
    return per_search_ms(r, "search.upload", "device_s")
