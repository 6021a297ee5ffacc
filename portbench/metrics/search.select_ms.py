"""search.select_ms: the device time of the program's `search.select`
spans (the int64 keys and top-k of each score chunk, the candidates' sort;
in refseq-batch the coarse route's top-2048) over the window, per call of
the index's search, in ms."""

from portbench.program_trace import per_search_ms


def read(r):
    return per_search_ms(r, "search.select", "device_s")
