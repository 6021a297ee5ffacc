"""search.rescore_ms: the host wall of the program's `search.rescore` span
(the graph index's exact re-score from the host signatures, with its sort
and gathers) over the window, per call of the index's search, in ms."""

from portbench.program_trace import per_search_ms


def read(r):
    return per_search_ms(r, "search.rescore", "wall_s")
