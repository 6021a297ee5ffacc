"""search.rescore_us_per_row: the host's cost of re-scoring one fetched row
exactly: the wall of the program's `search.rescore` span (the graph
index's re-score from the host signatures, with its sort and gathers)
over its counter `search.rescore_rows`, both over the window, in us.  A
cost a row, so fetching more rows a query for recall does not read as
worse."""

from portbench.program_trace import counter, span


def read(r):
    wall, rows = span(r, "search.rescore", "wall_s"), counter(r, "search.rescore_rows")
    return wall / rows * 1e6 if wall is not None and rows else None
